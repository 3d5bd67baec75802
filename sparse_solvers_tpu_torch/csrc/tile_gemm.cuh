// Tile GEMMs of K1 (normal_bf16.cu), K5 and K6 (fused_corr.cu).
//
// C (M,N) = L (M,K) · B (K,N), every matrix row-major. B comes from a
// matrix R that is stored either (N,K) (R_NK: B = Rᵀ, how the first pass of
// a normal product reads A) or (K,N) (B = R, how the second pass reads it).
// With SUB the epilogue writes E − L·B instead, E (M,N) with C's leading
// dimension (K6's residual Y − X·Aᵀ). No split-K and no atomics: each output
// is one block's fixed-order sum, so repeat runs are bit-identical.
//
//   gemm_bf16_async_kernel  K1's two passes. bf16 operands only, C f32 or
//                     bf16. 128x64 block tiles (128 batch lanes), eight
//                     warps of 32x32, each 2x4 mma.sync m16n8k16 products
//                     (fp32 accumulators) on fragments that ldmatrix reads,
//                     and a ring of STAGES 32-deep slices in dynamic shared
//                     memory filled by 16-byte cp.async copies: slice
//                     k+STAGES-1 is in flight while slice k is multiplied.
//                     Constants in namespace ring; ops/cuda/kernels.py::
//                     k1_launch_plan states the same.
//   gemm_bf16_kernel  K5's and K6's "default" passes. bf16 tensor cores
//                     (WMMA 16x16x16, fp32 accumulators), 64x64 block
//                     tiles, four warps of 32x32, one synchronous 32-deep
//                     shared-memory stage. f32 operands are rounded to bf16
//                     as they are staged (a cp.async copy cannot convert),
//                     so no bf16 copy of them is ever written; a bf16 C is
//                     rounded in the epilogue.
//   gemm_f32_kernel   K5's and K6's "highest"/"high" passes: fp32 FMAs on
//                     the CUDA cores (no TF32), BMxBN block tiles of TMxTN
//                     per thread, a 16-deep shared stage.
//
// Any M, N, K: ragged tile edges load zeros and store masked.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace tile_gemm {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;   // rows of C per block (batch lanes)
constexpr int BN = 64;   // columns of C per block
constexpr int BK = 32;   // depth of one shared-memory slice
constexpr int THREADS = 128;
constexpr int LDA = BK + 8;      // As[BM][LDA]  (bf16, rows 16-byte aligned)
constexpr int LDB_NK = BK + 8;   // Bs[BN][LDB_NK] when R is (N,K): col-major B
constexpr int LDB_KN = BN + 8;   // Bs[BK][LDB_KN] when R is (K,N): row-major B
constexpr int LDC = BN + 4;      // Cs[BM][LDC]  (f32 epilogue staging)
constexpr int B_ELEMS = (BN * LDB_NK > BK * LDB_KN) ? BN * LDB_NK : BK * LDB_KN;

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }

// Eight consecutive elements of row `row` starting at column `col` of a
// row-major (rows, cols) matrix with leading dimension ld, as bf16, zero
// outside the matrix. `vec` says 16-byte vector loads are aligned.
__device__ __forceinline__ void load8(const float* p, int rows, int cols,
                                      int ld, int row, int col, bool vec,
                                      bf16 out[8]) {
  if (row < rows && col + 8 <= cols && vec) {
    const float4* q = reinterpret_cast<const float4*>(p + (size_t)row * ld + col);
    float4 a = q[0], b = q[1];
    out[0] = to_bf16(a.x); out[1] = to_bf16(a.y);
    out[2] = to_bf16(a.z); out[3] = to_bf16(a.w);
    out[4] = to_bf16(b.x); out[5] = to_bf16(b.y);
    out[6] = to_bf16(b.z); out[7] = to_bf16(b.w);
    return;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t)
    out[t] = (row < rows && col + t < cols)
                 ? to_bf16(p[(size_t)row * ld + col + t]) : to_bf16(0.0f);
}

__device__ __forceinline__ void load8(const bf16* p, int rows, int cols,
                                      int ld, int row, int col, bool vec,
                                      bf16 out[8]) {
  if (row < rows && col + 8 <= cols && vec) {
    uint4 v = *reinterpret_cast<const uint4*>(p + (size_t)row * ld + col);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t) out[t] = e[t];
    return;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t)
    out[t] = (row < rows && col + t < cols)
                 ? p[(size_t)row * ld + col + t] : to_bf16(0.0f);
}

__device__ __forceinline__ void store8(bf16* dst, const bf16 v[8]) {
  uint4 packed;
  bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
  for (int t = 0; t < 8; ++t) e[t] = v[t];
  *reinterpret_cast<uint4*>(dst) = packed;
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  // src-size 0 reads nothing and writes 16 zero bytes
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Stage the eight bf16 at (row, col) of a row-major (rows, cols) matrix
// with leading dimension ld into dst (16 bytes, aligned), zero outside the
// matrix: a cp.async where the chunk lies wholly inside an aligned row
// (`vec`: the base is 16-byte aligned and ld a multiple of 8), its
// zero-fill form past the edge, else element by element through registers
// (past the edge too, when the base is not aligned for a copy).
__device__ __forceinline__ void stage8(bf16* dst, const bf16* p, int rows,
                                       int cols, int ld, int row, int col,
                                       bool vec) {
  const bool inside = row < rows && col < cols;
  const bf16* src = inside ? p + (size_t)row * ld + col : p;
  if (vec && (!inside || col + 8 <= cols)) {
    cp_async16(dst, src, inside);
    return;
  }
  bf16 v[8];
#pragma unroll
  for (int t = 0; t < 8; ++t)
    v[t] = inside && col + t < cols ? src[t] : to_bf16(0.0f);
  store8(dst, v);
}

// ldmatrix: four 8x8 bf16 matrices from shared memory, lanes 8q..8q+7
// giving the row addresses of matrix q; lane l receives, of each matrix,
// row l/4, columns 2(l%4) and 2(l%4)+1 (of the transpose with _trans).
__device__ __forceinline__ void ldsm_x4(unsigned r[4], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned r[4], const bf16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// c (16x8 f32) += a (16x16 bf16, row-major fragment) · b (16x8, col-major)
__device__ __forceinline__ void mma_16816(float c[4], const unsigned a[4],
                                          const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// gemm_bf16_async_kernel's geometry (ops/cuda/kernels.py::k1_launch_plan
// states the same numbers; tests/test_torch_k1_plan.py reads them here).
namespace ring {
constexpr int BM = 128;       // rows of C per block (batch lanes)
constexpr int BN = 64;        // columns of C per block
constexpr int BK = 32;        // depth of one slice
constexpr int STAGES = 4;     // slices in the ring
constexpr int THREADS = 256;  // eight warps of 32x32, 4 down and 2 across
constexpr int LDA = BK + 8;     // As[BM][LDA]
constexpr int LDB_NK = BK + 8;  // Bs[BN][LDB_NK] when R is (N,K)
constexpr int LDB_KN = BN + 8;  // Bs[BK][LDB_KN] when R is (K,N)
constexpr int LDC = BN + 4;     // Cs[BM][LDC], f32, on the ring's memory
constexpr int A_ELEMS = BM * LDA;
constexpr int B_ELEMS = (BN * LDB_NK > BK * LDB_KN) ? BN * LDB_NK : BK * LDB_KN;
constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;
constexpr int SMEM_BYTES = (RING_BYTES > BM * LDC * 4) ? RING_BYTES : BM * LDC * 4;
static_assert(SMEM_BYTES <= 232448, "past a block's shared memory");
static_assert((STAGE_ELEMS * 2) % 128 == 0 && (A_ELEMS * 2) % 32 == 0,
              "ldmatrix and cp.async need aligned stage bases");

// C = L·B, L (M,K) and R bf16, C f32 or bf16 (rounded to nearest even).
// Launch with THREADS threads and SMEM_BYTES of dynamic shared
// memory (after cudaFuncSetAttribute), grid (ceil(M/BM), ceil(N/BN)): the
// batch tiles run along blockIdx.x, so blocks that share an R tile are
// adjacent. vec_l / vec_r: 16-byte copies are aligned (base aligned, ld a
// multiple of 8); vec_c: four-element stores of C are aligned.
//
// The ring: the prologue puts slices 0..STAGES-2 in flight, one cp.async
// group each. Iteration k waits until slice k's group has landed
// (wait_group STAGES-2), meets the block at one barrier (slice k visible
// to all; every warp done with slice k-1), refills slice k-1's slot with
// slice k+STAGES-1 and multiplies slice k. Element-wise stores of ragged
// chunks go to the slot being refilled, so the same barrier covers them.
template <typename TC, bool R_NK>
__global__ void __launch_bounds__(THREADS)
gemm_bf16_async_kernel(const bf16* __restrict__ L, const bf16* __restrict__ R,
                       TC* __restrict__ C, int M, int N, int K, int ldl,
                       int ldr, int ldc, bool vec_l, bool vec_r, bool vec_c) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* slots = reinterpret_cast<bf16*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // warp's 32x32 sub-tile
  const int wn = (warp % 2) * 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  // slice kt into its slot in chunks of 8: L is BM x BK (512 chunks, two
  // per thread), R is BN x BK (N,K layout) or BK x BN (K,N) (256, one)
  static_assert((BM * BK / 8) % THREADS == 0 && (BN * BK / 8) % THREADS == 0,
                "every thread stages the same number of chunks");
  auto load_slice = [&](int kt) {
    bf16* As = slots + (kt % STAGES) * STAGE_ELEMS;
    bf16* Bs = As + A_ELEMS;
    const int k0 = kt * BK;
#pragma unroll
    for (int ch = tid; ch < BM * BK / 8; ch += THREADS) {
      const int r = ch / (BK / 8), c8 = (ch % (BK / 8)) * 8;
      stage8(&As[r * LDA + c8], L, M, K, ldl, m0 + r, k0 + c8, vec_l);
    }
#pragma unroll
    for (int ch = tid; ch < BN * BK / 8; ch += THREADS) {
      if (R_NK) {
        const int r = ch / (BK / 8), c8 = (ch % (BK / 8)) * 8;
        stage8(&Bs[r * LDB_NK + c8], R, N, K, ldr, n0 + r, k0 + c8, vec_r);
      } else {
        const int r = ch / (BN / 8), c8 = (ch % (BN / 8)) * 8;
        stage8(&Bs[r * LDB_KN + c8], R, K, N, ldr, k0 + r, n0 + c8, vec_r);
      }
    }
  };

  // the warp's 32x32 as 2x4 mma.sync tiles of 16x8: [16-row block][8-column
  // block][c0..c3], c0 c1 at row g, columns 2t and 2t+1, c2 c3 at row g+8
  float acc[2][4][4] = {};
  const int lane = tid % 32;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_slice(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load_slice(kt + STAGES - 1);
    cp_async_commit();  // empty groups at the tail keep the count even

    const bf16* As = slots + (kt % STAGES) * STAGE_ELEMS;
    const bf16* Bs = As + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A: per 16-row block, the four 8x8 matrices (rows 0-7 | 8-15) x
      // (k 0-7 | 8-15); lane l points at row l%16, k (l/16)*8
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], &As[(wm + i * 16 + lane % 16) * LDA + kk + (lane / 16) * 8]);
      // B: per 16 columns, (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
      // (n 8-15, k 8-15); Bs[n][k] loads as it is, Bs[k][n] transposed
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        unsigned r[4];
        const int n = wn + jj * 16 + (lane / 16) * 8;
        const int k = kk + ((lane / 8) % 2) * 8;
        if (R_NK)
          ldsm_x4(r, &Bs[(n + lane % 8) * LDB_NK + k]);
        else
          ldsm_x4_trans(r, &Bs[(k + lane % 8) * LDB_KN + n]);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_16816(acc[i][j], a[i], b[j]);
    }
  }

  // the f32 staging reuses the ring's memory once every copy has landed
  // and every warp is done with the last slice
  cp_async_wait<0>();
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* c = &Cs[(wm + i * 16 + g) * LDC + wn + j * 8 + 2 * t];
      c[0] = acc[i][j][0];
      c[1] = acc[i][j][1];
      c[8 * LDC] = acc[i][j][2];
      c[8 * LDC + 1] = acc[i][j][3];
    }
  __syncthreads();
  for (int e = tid; e < BM * BN / 4; e += THREADS) {
    const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= M) continue;
    const float* v = &Cs[r * LDC + c];
    TC* dst = C + (size_t)gr * ldc + gc;
    if (vec_c && gc + 4 <= N) {
      store4(dst, v);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (gc + t < N) store_out(dst + t, v[t]);
    }
  }
}

}  // namespace ring

template <typename TL, typename TR, typename TC, bool R_NK, bool SUB>
__global__ void __launch_bounds__(THREADS)
gemm_bf16_kernel(const TL* __restrict__ L, const TR* __restrict__ R,
                 TC* __restrict__ C, const float* __restrict__ E,
                 int M, int N, int K, int ldl, int ldr, int ldc,
                 bool vec_l, bool vec_r) {
  __shared__ __align__(32) bf16 As[BM * LDA];
  __shared__ __align__(32) bf16 Bs[B_ELEMS];
  __shared__ __align__(32) float Cs[BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // warp's 32x32 sub-tile
  const int wn = (warp % 2) * 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  using BLayout = typename std::conditional<R_NK, wmma::col_major,
                                            wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // L slice: BM x BK = 256 chunks of 8, two per thread
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int ch = tid + it * THREADS;
      const int r = ch / (BK / 8), c8 = (ch % (BK / 8)) * 8;
      bf16 v[8];
      load8(L, M, K, ldl, m0 + r, k0 + c8, vec_l, v);
      store8(&As[r * LDA + c8], v);
    }
    // R slice: BN x BK (N,K layout) or BK x BN (K,N layout), 256 chunks
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int ch = tid + it * THREADS;
      bf16 v[8];
      if (R_NK) {
        const int r = ch / (BK / 8), c8 = (ch % (BK / 8)) * 8;
        load8(R, N, K, ldr, n0 + r, k0 + c8, vec_r, v);
        store8(&Bs[r * LDB_NK + c8], v);
      } else {
        const int r = ch / (BN / 8), c8 = (ch % (BN / 8)) * 8;
        load8(R, K, N, ldr, k0 + r, n0 + c8, vec_r, v);
        store8(&Bs[r * LDB_KN + c8], v);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm + i * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (R_NK)  // B(k, n) = Bs[n][k]
          wmma::load_matrix_sync(b[j], &Bs[(wn + j * 16) * LDB_NK + kk], LDB_NK);
        else       // B(k, n) = Bs[k][n]
          wmma::load_matrix_sync(b[j], &Bs[kk * LDB_KN + wn + j * 16], LDB_KN);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm + i * 16) * LDC + wn + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) {
      const size_t o = (size_t)gr * ldc + gc;
      const float v = Cs[r * LDC + c];
      store_out(&C[o], SUB ? E[o] - v : v);
    }
  }
}

// fp32 tile GEMM: block tile FBM x FBN, each thread an FTM x FTN patch of
// C (rows ty*FTM.., columns tx*FTN..), a 16-deep slice of L and B staged
// k-major in shared memory (rows padded by one to spread the banks).
template <int FBM, int FBN, int FTM, int FTN, bool R_NK, bool SUB>
__global__ void __launch_bounds__((FBM / FTM) * (FBN / FTN))
gemm_f32_kernel(const float* __restrict__ L, const float* __restrict__ R,
                float* __restrict__ C, const float* __restrict__ E,
                int M, int N, int K, int ldl, int ldr, int ldc) {
  constexpr int FBK = 16;
  constexpr int TX = FBN / FTN;
  constexpr int NT = (FBM / FTM) * TX;
  __shared__ float As[FBK][FBM + 1];
  __shared__ float Bs[FBK][FBN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;

  float acc[FTM][FTN];
#pragma unroll
  for (int i = 0; i < FTM; ++i)
#pragma unroll
    for (int j = 0; j < FTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int e = tid; e < FBM * FBK; e += NT) {
      const int r = e / FBK, c = e % FBK;
      const int gr = m0 + r, gk = k0 + c;
      As[c][r] = (gr < M && gk < K) ? L[(size_t)gr * ldl + gk] : 0.0f;
    }
    for (int e = tid; e < FBN * FBK; e += NT) {
      if (R_NK) {  // B(k, n) = R[n][k]
        const int r = e / FBK, c = e % FBK;
        const int gn = n0 + r, gk = k0 + c;
        Bs[c][r] = (gn < N && gk < K) ? R[(size_t)gn * ldr + gk] : 0.0f;
      } else {     // B(k, n) = R[k][n]
        const int r = e / FBN, c = e % FBN;
        const int gk = k0 + r, gn = n0 + c;
        Bs[r][c] = (gk < K && gn < N) ? R[(size_t)gk * ldr + gn] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[FTM], b[FTN];
#pragma unroll
      for (int i = 0; i < FTM; ++i) a[i] = As[kk][ty * FTM + i];
#pragma unroll
      for (int j = 0; j < FTN; ++j) b[j] = Bs[kk][tx * FTN + j];
#pragma unroll
      for (int i = 0; i < FTM; ++i)
#pragma unroll
        for (int j = 0; j < FTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FTM; ++i) {
    const int gr = m0 + ty * FTM + i;
#pragma unroll
    for (int j = 0; j < FTN; ++j) {
      const int gc = n0 + tx * FTN + j;
      if (gr < M && gc < N) {
        const size_t o = (size_t)gr * ldc + gc;
        C[o] = SUB ? E[o] - acc[i][j] : acc[i][j];
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace tile_gemm
