// Tile GEMMs of K1 (normal_bf16.cu), K5 and K6 (fused_corr.cu).
//
// C (M,N) = L (M,K) · B (K,N), every matrix row-major. B comes from a
// matrix R that is stored either (N,K) (R_NK: B = Rᵀ, how the first pass of
// a normal product reads A) or (K,N) (B = R, how the second pass reads it).
//
//   ring::gemm_bf16_async_kernel  bf16 operands, C f32 or bf16. TBMxTBN
//                     block tiles (K1: 128x64; K5's and K6's "default":
//                     16x64, 64x64 or 128x128), warps of 32x32 (16x32 at
//                     TBM 16), each 2x4 mma.sync m16n8k16 products (fp32
//                     accumulators) on fragments that ldmatrix reads, and a
//                     ring of TSTAGES TBK-deep slices (K1: four of 32; K5,
//                     K6: three of 64) in dynamic shared memory filled by
//                     16-byte cp.async copies: slice k+TSTAGES-1 is in
//                     flight while slice k is multiplied. K1's constants in
//                     namespace ring; ops/cuda/kernels.py::k1_launch_plan
//                     and fused_launch_plan state the same.
//   f32ring::gemm_f32_async_kernel  K5's and K6's "highest"/"high": fp32
//                     FMAs on the CUDA cores (no TF32), BMx128 block tiles
//                     of TMx8 outputs per thread, f32 slices staged as they
//                     are by cp.async into a ring of STAGES 32-deep slices,
//                     read back as float4 along whichever dimension is
//                     contiguous. Constants in namespace f32ring;
//                     ops/cuda/kernels.py::fused_launch_plan states the same.
//
// Split-K (K5 and K6): a kernel takes the depth range of split blockIdx.z,
// [z·k_chunk, min(K, (z+1)·k_chunk)), and writes its sums to C + z·M·ldc;
// the caller sums the splits in the fixed order z = 0..S-1
// (sum_splits_kernel). No atomics: every output is a fixed-order sum, so
// repeat runs are bit-identical. Any M, N, K: ragged tile edges load zeros
// and store masked.
//
// Everything here has internal linkage, so each source that includes the
// header builds and launches its own copies.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace tile_gemm {
namespace {

using bf16 = __nv_bfloat16;

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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

__device__ __forceinline__ void store8(bf16* dst, const bf16 v[8]) {
  uint4 packed;
  bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
  for (int t = 0; t < 8; ++t) e[t] = v[t];
  *reinterpret_cast<uint4*>(dst) = packed;
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
    v[t] = inside && col + t < cols ? src[t] : __float2bfloat16_rn(0.0f);
  store8(dst, v);
}

// stage8's f32 form: the four f32 at (row, col), `vec` when the base is
// 16-byte aligned and ld a multiple of 4.
__device__ __forceinline__ void stage4(float* dst, const float* p, int rows,
                                       int cols, int ld, int row, int col,
                                       bool vec) {
  const bool inside = row < rows && col < cols;
  const float* src = inside ? p + (size_t)row * ld + col : p;
  if (vec && (!inside || col + 4 <= cols)) {
    cp_async16(dst, src, inside);
    return;
  }
  float v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = inside && col + t < cols ? src[t] : 0.0f;
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
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

// A block's depth range [kbeg, kend) and its slice count: split
// blockIdx.z's range of k_chunk, or the whole depth.
struct Split {
  int kbeg, kend, nk;
  __device__ __forceinline__ Split(int K, int k_chunk, int bk) {
    kbeg = blockIdx.z * k_chunk;
    kend = min(K, kbeg + k_chunk);
    nk = kend > kbeg ? (kend - kbeg + bk - 1) / bk : 0;
  }
  __device__ __forceinline__ Split(int K, int bk)
      : kbeg(0), kend(K), nk((K + bk - 1) / bk) {}
};

// Sets a kernel's dynamic shared-memory limit once per device before its
// first launch (above 48 KB a launch needs it). `ready` is the caller's
// per-kernel bit set.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit);
  }
  return cudaSuccess;
}

// gemm_bf16_async_kernel's geometry: K1's tile (ops/cuda/kernels.py::
// k1_launch_plan states the same numbers; tests/test_torch_k1_plan.py reads
// them here), and the Tile each instantiation takes.
namespace ring {
constexpr int BM = 128;       // K1's rows of C per block (batch lanes)
constexpr int BN = 64;        // K1's columns of C per block
constexpr int BK = 32;        // K1's depth of one slice
constexpr int STAGES = 4;     // K1's slices in the ring
constexpr int THREADS = 256;  // K1: eight warps of 32x32, 4 down and 2 across
constexpr int LDA = BK + 8;     // K1's As[BM][LDA]

// A TBMxTBN tile over TBK-deep slices, TSTAGES of them in the ring: warps
// of (16·MI)x32, TBM/(16·MI) down and TBN/32 across, and the ring and the
// epilogue staging in dynamic shared memory (rows padded by 8 bf16).
template <int TBM, int TBN, int TBK, int TSTAGES>
struct Tile {
  static constexpr int MI = TBM >= 32 ? 2 : 1;  // 16-row mma blocks a warp
  static constexpr int WARPS_N = TBN / 32;
  static constexpr int THREADS = TBM / (16 * MI) * WARPS_N * 32;
  static constexpr int LDA = TBK + 8;     // As[TBM][LDA]
  static constexpr int LDB_NK = TBK + 8;  // Bs[TBN][LDB_NK] when R is (N,K)
  static constexpr int LDB_KN = TBN + 8;  // Bs[TBK][LDB_KN] when R is (K,N)
  static constexpr int LDC = TBN + 4;     // Cs[TBM][LDC], f32, on the ring
  static constexpr int A_ELEMS = TBM * LDA;
  static constexpr int B_ELEMS =
      TBN * LDB_NK > TBK * LDB_KN ? TBN * LDB_NK : TBK * LDB_KN;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
  static constexpr int RING_BYTES = TSTAGES * STAGE_ELEMS * 2;
  static constexpr int SMEM_BYTES =
      RING_BYTES > TBM * LDC * 4 ? RING_BYTES : TBM * LDC * 4;
  static_assert(SMEM_BYTES <= 232448, "past a block's shared memory");
  static_assert((STAGE_ELEMS * 2) % 128 == 0 && (A_ELEMS * 2) % 32 == 0,
                "ldmatrix and cp.async need aligned stage bases");
};
using K1Tile = Tile<BM, BN, BK, STAGES>;
constexpr int SMEM_BYTES = K1Tile::SMEM_BYTES;
static_assert(K1Tile::THREADS == THREADS && K1Tile::LDA == LDA,
              "K1's eight warps and padded rows");

// C = L·B, L (M,K) and R bf16, C f32 or bf16 (rounded to nearest even);
// with SPLIT over split blockIdx.z's depth range (see Split) into C +
// z·M·ldc. Launch with Tile::THREADS threads and Tile::SMEM_BYTES of
// dynamic shared memory (after cudaFuncSetAttribute), grid (ceil(M/TBM),
// ceil(N/TBN), S): the batch tiles run along blockIdx.x, so blocks that
// share an R tile are adjacent. K1 runs it without SPLIT: the split's
// bounds cost its first pass 6 % (tools/probe_k1_ring.py). vec_l / vec_r:
// 16-byte copies are aligned (base aligned, ld a multiple of 8); vec_c:
// four-element stores of C are aligned.
//
// The ring: the prologue puts slices 0..TSTAGES-2 in flight, one cp.async
// group each. Iteration k waits until slice k's group has landed
// (wait_group TSTAGES-2), meets the block at one barrier (slice k visible
// to all; every warp done with slice k-1), refills slice k-1's slot with
// slice k+TSTAGES-1 and multiplies slice k. Element-wise stores of ragged
// chunks go to the slot being refilled, so the same barrier covers them.
template <typename TC, bool R_NK, int TBM = BM, int TBN = BN, int TBK = BK,
          int TSTAGES = STAGES, bool SPLIT = false>
__global__ void __launch_bounds__(Tile<TBM, TBN, TBK, TSTAGES>::THREADS)
gemm_bf16_async_kernel(const bf16* __restrict__ L, const bf16* __restrict__ R,
                       TC* __restrict__ C, int M, int N, int K, int ldl,
                       int ldr, int ldc, int k_chunk, bool vec_l, bool vec_r,
                       bool vec_c) {
  using G = Tile<TBM, TBN, TBK, TSTAGES>;
  constexpr int MI = G::MI, NT = G::THREADS, LDA = G::LDA;
  constexpr int LDB_NK = G::LDB_NK, LDB_KN = G::LDB_KN, LDC = G::LDC;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* slots = reinterpret_cast<bf16*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / G::WARPS_N) * 16 * MI;  // warp's (16·MI)x32 tile
  const int wn = (warp % G::WARPS_N) * 32;
  const int m0 = blockIdx.x * TBM;
  const int n0 = blockIdx.y * TBN;
  const Split sp = SPLIT ? Split(K, k_chunk, TBK) : Split(K, TBK);
  if (SPLIT) C += (size_t)blockIdx.z * M * ldc;

  // slice kt into its slot in chunks of 8: L is TBM x TBK, R is TBN x TBK
  // (N,K layout) or TBK x TBN (K,N)
  static_assert((TBM * TBK / 8) % NT == 0 && (TBN * TBK / 8) % NT == 0,
                "every thread stages the same number of chunks");
  auto load_slice = [&](int kt) {
    bf16* As = slots + (kt % TSTAGES) * G::STAGE_ELEMS;
    bf16* Bs = As + G::A_ELEMS;
    const int k0 = sp.kbeg + kt * TBK;
#pragma unroll
    for (int ch = tid; ch < TBM * TBK / 8; ch += NT) {
      const int r = ch / (TBK / 8), c8 = (ch % (TBK / 8)) * 8;
      stage8(&As[r * LDA + c8], L, M, sp.kend, ldl, m0 + r, k0 + c8, vec_l);
    }
#pragma unroll
    for (int ch = tid; ch < TBN * TBK / 8; ch += NT) {
      if (R_NK) {
        const int r = ch / (TBK / 8), c8 = (ch % (TBK / 8)) * 8;
        stage8(&Bs[r * LDB_NK + c8], R, N, sp.kend, ldr, n0 + r, k0 + c8,
               vec_r);
      } else {
        const int r = ch / (TBN / 8), c8 = (ch % (TBN / 8)) * 8;
        stage8(&Bs[r * LDB_KN + c8], R, sp.kend, N, ldr, k0 + r, n0 + c8,
               vec_r);
      }
    }
  };

  // the warp's (16·MI)x32 as MIx4 mma.sync tiles of 16x8: [16-row
  // block][8-column block][c0..c3], c0 c1 at row g, columns 2t and 2t+1,
  // c2 c3 at row g+8
  float acc[MI][4][4] = {};
  const int lane = tid % 32;
  const int nk = sp.nk;

#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < nk) load_slice(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TSTAGES - 2>();
    __syncthreads();
    if (kt + TSTAGES - 1 < nk) load_slice(kt + TSTAGES - 1);
    cp_async_commit();  // empty groups at the tail keep the count even

    const bf16* As = slots + (kt % TSTAGES) * G::STAGE_ELEMS;
    const bf16* Bs = As + G::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      // A: per 16-row block, the four 8x8 matrices (rows 0-7 | 8-15) x
      // (k 0-7 | 8-15); lane l points at row l%16, k (l/16)*8
      unsigned a[MI][4], b[4][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
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
      for (int i = 0; i < MI; ++i)
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
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* c = &Cs[(wm + i * 16 + g) * LDC + wn + j * 8 + 2 * t];
      c[0] = acc[i][j][0];
      c[1] = acc[i][j][1];
      c[8 * LDC] = acc[i][j][2];
      c[8 * LDC + 1] = acc[i][j][3];
    }
  __syncthreads();
  for (int e = tid; e < TBM * TBN / 4; e += NT) {
    const int r = e / (TBN / 4), c = (e % (TBN / 4)) * 4;
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

// C = L·B on the ring kernel, with SPLIT in `splits` depth ranges of
// k_chunk (C is then (splits, M, ldc)); sets the shared-memory attribute
// once per instantiation and device before the first launch.
template <typename TC, bool R_NK, int TBM = BM, int TBN = BN, int TBK = BK,
          int TSTAGES = STAGES, bool SPLIT = false>
cudaError_t launch_ring(const bf16* L, const bf16* R, TC* C, int M, int N,
                        int K, int ldl, int ldr, int ldc, int splits,
                        int k_chunk, cudaStream_t stream) {
  using G = Tile<TBM, TBN, TBK, TSTAGES>;
  static std::atomic<unsigned long long> ready{0};  // a bit per device
  cudaError_t err = allow_smem(
      gemm_bf16_async_kernel<TC, R_NK, TBM, TBN, TBK, TSTAGES, SPLIT>,
      G::SMEM_BYTES, ready);
  if (err != cudaSuccess) return err;
  const size_t c_align = sizeof(TC) * 4;  // a four-element store
  const bool vec_c = (reinterpret_cast<uintptr_t>(C) % c_align) == 0 &&
                     ldc % 4 == 0;
  const dim3 grid((M + TBM - 1) / TBM, (N + TBN - 1) / TBN,
                  SPLIT ? splits : 1);
  gemm_bf16_async_kernel<TC, R_NK, TBM, TBN, TBK, TSTAGES, SPLIT>
      <<<grid, G::THREADS, G::SMEM_BYTES, stream>>>(
          L, R, C, M, N, K, ldl, ldr, ldc, k_chunk,
          aligned16(L) && ldl % 8 == 0, aligned16(R) && ldr % 8 == 0, vec_c);
  return cudaGetLastError();
}

}  // namespace ring

// gemm_f32_async_kernel's geometry (ops/cuda/kernels.py::fused_launch_plan
// states the same numbers; tests/test_torch_fused_plan.py reads them here).
namespace f32ring {
constexpr int BN = 128;       // columns of C per block
constexpr int BK = 32;        // depth of one slice
constexpr int STAGES = 3;     // slices in the ring
constexpr int TN = 8;         // columns of C per thread
constexpr int TM = 8;         // rows of C per thread, batch tiles of 64, 128
constexpr int TM_SMALL = 2;   // rows of C per thread, the batch tile of 16
constexpr int LDK = BK + 4;   // [row][k] slices: L, and R when it is (N,K)
constexpr int LDN = BN + 4;   // [k][col] slices: R when it is (K,N)
constexpr int R_ELEMS = (BN * LDK > BK * LDN) ? BN * LDK : BK * LDN;

// A batch tile of BM lanes: a (BM/TMB) x (BN/TN) grid of threads, thread
// (ty, tx) holding rows ty + i·TY and, for R (N,K), columns tx + j·TX or,
// for R (K,N), the four-column groups 4·(tx + j·TX).
template <int BM>
struct Tile {
  static constexpr int TMB = BM >= 64 ? TM : TM_SMALL;
  static constexpr int TY = BM / TMB;
  static constexpr int TX = BN / TN;
  static constexpr int THREADS = TY * TX;
  static constexpr int L_ELEMS = BM * LDK;
  static constexpr int STAGE_ELEMS = L_ELEMS + R_ELEMS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 4;
  static_assert(SMEM_BYTES <= 232448, "past a block's shared memory");
  static_assert((STAGE_ELEMS * 4) % 16 == 0 && (L_ELEMS * 4) % 16 == 0,
                "cp.async and float4 reads need aligned stage bases");
};

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// C = L·B over split blockIdx.z's depth range (see Split) into C +
// z·M·ldc, or E − L·B when E is given (E (M,N) with C's leading dimension;
// only with one split), all f32, fp32 FMAs in k order. Launch with Tile<BM>::THREADS threads and
// Tile<BM>::SMEM_BYTES of dynamic shared memory, grid (ceil(M/BM),
// ceil(N/BN), S). vec_l / vec_r: 16-byte copies are aligned (base aligned,
// ld a multiple of 4); vec_c: float4 stores of C are aligned.
//
// The ring is the bf16 kernel's: STAGES-1 slices in flight, one barrier
// per slice. Each slice is read from shared memory as float4: L as
// [row][k] along k; R (N,K) as [col][k] along k; R (K,N) as [k][col]
// along the columns. Per four depth steps a thread reads TMB + TN float4
// and does 4·TMB·TN FMAs. The padded rows (LDK ≡ 4 mod 32 words) put the
// eight float4 of a quarter warp on distinct banks.
template <int BM, bool R_NK>
__global__ void __launch_bounds__(Tile<BM>::THREADS)
gemm_f32_async_kernel(const float* __restrict__ L, const float* __restrict__ R,
                      float* __restrict__ C, const float* __restrict__ E,
                      int M, int N, int K, int ldl, int ldr, int ldc,
                      int k_chunk, bool vec_l, bool vec_r, bool vec_c) {
  using G = Tile<BM>;
  constexpr int TMB = G::TMB, TY = G::TY, TX = G::TX, NT = G::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* slots = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const Split sp(K, k_chunk, BK);
  C += (size_t)blockIdx.z * M * ldc;

  static_assert((BM * BK / 4) % NT == 0 && (BN * BK / 4) % NT == 0,
                "every thread stages the same number of chunks");
  auto load_slice = [&](int kt) {
    float* Ls = slots + (kt % STAGES) * G::STAGE_ELEMS;
    float* Rs = Ls + G::L_ELEMS;
    const int k0 = sp.kbeg + kt * BK;
#pragma unroll
    for (int ch = tid; ch < BM * BK / 4; ch += NT) {
      const int r = ch / (BK / 4), c4 = (ch % (BK / 4)) * 4;
      stage4(&Ls[r * LDK + c4], L, M, sp.kend, ldl, m0 + r, k0 + c4, vec_l);
    }
#pragma unroll
    for (int ch = tid; ch < BN * BK / 4; ch += NT) {
      if (R_NK) {
        const int r = ch / (BK / 4), c4 = (ch % (BK / 4)) * 4;
        stage4(&Rs[r * LDK + c4], R, N, sp.kend, ldr, n0 + r, k0 + c4,
               vec_r);
      } else {
        const int r = ch / (BN / 4), c4 = (ch % (BN / 4)) * 4;
        stage4(&Rs[r * LDN + c4], R, sp.kend, N, ldr, k0 + r, n0 + c4,
               vec_r);
      }
    }
  };

  float acc[TMB][TN];
#pragma unroll
  for (int i = 0; i < TMB; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  const int nk = sp.nk;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_slice(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load_slice(kt + STAGES - 1);
    cp_async_commit();

    const float* Ls = slots + (kt % STAGES) * G::STAGE_ELEMS;
    const float* Rs = Ls + G::L_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TMB];
#pragma unroll
      for (int i = 0; i < TMB; ++i)
        a[i] = *reinterpret_cast<const float4*>(&Ls[(ty + i * TY) * LDK + kk]);
      if (R_NK) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 b =
              *reinterpret_cast<const float4*>(&Rs[(tx + j * TX) * LDK + kk]);
#pragma unroll
          for (int i = 0; i < TMB; ++i) {
            acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j4 = 0; j4 < TN / 4; ++j4) {
            const float4 b = *reinterpret_cast<const float4*>(
                &Rs[(kk + q) * LDN + (tx + j4 * TX) * 4]);
#pragma unroll
            for (int i = 0; i < TMB; ++i) {
              const float ai = lane4(a[i], q);
              acc[i][4 * j4 + 0] = fmaf(ai, b.x, acc[i][4 * j4 + 0]);
              acc[i][4 * j4 + 1] = fmaf(ai, b.y, acc[i][4 * j4 + 1]);
              acc[i][4 * j4 + 2] = fmaf(ai, b.z, acc[i][4 * j4 + 2]);
              acc[i][4 * j4 + 3] = fmaf(ai, b.w, acc[i][4 * j4 + 3]);
            }
          }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TMB; ++i) {
    const int gr = m0 + ty + i * TY;
    if (gr >= M) continue;
    const size_t row = (size_t)gr * ldc;
    if (R_NK) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gc = n0 + tx + j * TX;
        if (gc < N) C[row + gc] = E ? E[row + gc] - acc[i][j] : acc[i][j];
      }
    } else {
#pragma unroll
      for (int j4 = 0; j4 < TN / 4; ++j4) {
        const int gc = n0 + (tx + j4 * TX) * 4;
        float v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          v[t] = E && gc + t < N ? E[row + gc + t] - acc[i][4 * j4 + t]
                                 : acc[i][4 * j4 + t];
        if (vec_c && gc + 4 <= N) {
          store4(C + row + gc, v);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (gc + t < N) C[row + gc + t] = v[t];
        }
      }
    }
  }
}

// C (or E − C) = L·B on the fp32 ring in `splits` depth ranges of k_chunk
// (C is then (splits, M, ldc)); sets the shared-memory attribute once per
// instantiation and device before the first launch.
template <int BM, bool R_NK>
cudaError_t launch(const float* L, const float* R, float* C, const float* E,
                   int M, int N, int K, int ldl, int ldr, int ldc, int splits,
                   int k_chunk, cudaStream_t stream) {
  using G = Tile<BM>;
  static std::atomic<unsigned long long> ready{0};  // a bit per device
  cudaError_t err = allow_smem(gemm_f32_async_kernel<BM, R_NK>,
                               G::SMEM_BYTES, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  gemm_f32_async_kernel<BM, R_NK><<<grid, G::THREADS, G::SMEM_BYTES, stream>>>(
      L, R, C, E, M, N, K, ldl, ldr, ldc, k_chunk,
      aligned16(L) && ldl % 4 == 0, aligned16(R) && ldr % 4 == 0,
      aligned16(C) && ldc % 4 == 0);
  return cudaGetLastError();
}

}  // namespace f32ring

// y = bf16(x) for `count` elements, round to nearest even, four at a time
// when `vec` (x 16-byte and y 8-byte aligned).
struct RoundJob {
  const float* x;
  bf16* y;
  size_t count;
  bool vec;
};

// Runs job a on blockIdx.y 0 and job b on blockIdx.y 1, so that two
// rounds share one launch.
__global__ void round_to_bf16_kernel(RoundJob a, RoundJob b) {
  const RoundJob j = blockIdx.y ? b : a;
  const float* __restrict__ x = j.x;
  bf16* __restrict__ y = j.y;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t tail = 0;
  if (j.vec) {
    for (size_t i = first; i < j.count / 4; i += stride) {
      const float4 v = reinterpret_cast<const float4*>(x)[i];
      store4(y + 4 * i, reinterpret_cast<const float*>(&v));
    }
    tail = j.count / 4 * 4;
  }
  for (size_t i = tail + first; i < j.count; i += stride)
    y[i] = __float2bfloat16_rn(x[i]);
}

// Grid-stride launches: a thread per `per_thread` elements, at most 4096
// blocks of 256 striding over the rest.
inline unsigned stride_blocks(size_t count, size_t per_thread) {
  const size_t want = (count / per_thread + 255) / 256 + 1;
  return want < 4096 ? (unsigned)want : 4096u;
}

inline RoundJob round_job(const float* x, bf16* y, size_t count) {
  return {x, y, count,
          aligned16(x) && reinterpret_cast<uintptr_t>(y) % 8 == 0};
}

// y = bf16(x), and y2 = bf16(x2) in the same launch when count2 > 0.
cudaError_t round_to_bf16(const float* x, bf16* y, size_t count,
                          cudaStream_t stream, const float* x2 = nullptr,
                          bf16* y2 = nullptr, size_t count2 = 0) {
  const dim3 grid(stride_blocks(count > count2 ? count : count2, 4),
                  count2 ? 2 : 1);
  round_to_bf16_kernel<<<grid, 256, 0, stream>>>(
      round_job(x, y, count), round_job(x2, y2, count2));
  return cudaGetLastError();
}

// out[i] = Σ_z P[z][i] for z = 0..S-1 in that order, or E[i] − that sum
// when E is given; P is (S, count) f32, out f32 or bf16 (nearest even).
// Four elements a thread at a time when `vec` (count a multiple of 4, P, E
// and out aligned for it).
template <typename TO>
__global__ void sum_splits_kernel(const float* __restrict__ P, int S,
                                  size_t count, const float* __restrict__ E,
                                  TO* __restrict__ out, bool vec) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const float4* P4 = reinterpret_cast<const float4*>(P);
    for (size_t i = first; i < count / 4; i += stride) {
      float4 s = P4[i];
      for (int z = 1; z < S; ++z) {
        const float4 p = P4[(size_t)z * (count / 4) + i];
        s.x += p.x;
        s.y += p.y;
        s.z += p.z;
        s.w += p.w;
      }
      if (E) {
        const float4 e = reinterpret_cast<const float4*>(E)[i];
        s = make_float4(e.x - s.x, e.y - s.y, e.z - s.z, e.w - s.w);
      }
      store4(out + 4 * i, reinterpret_cast<const float*>(&s));
    }
    return;
  }
  for (size_t i = first; i < count; i += stride) {
    float s = P[i];
    for (int z = 1; z < S; ++z) s += P[(size_t)z * count + i];
    store_out(out + i, E ? E[i] - s : s);
  }
}

template <typename TO>
cudaError_t sum_splits(const float* P, int S, size_t count, const float* E,
                       TO* out, cudaStream_t stream) {
  const bool vec = count % 4 == 0 && aligned16(P) && (!E || aligned16(E)) &&
                   reinterpret_cast<uintptr_t>(out) % (4 * sizeof(TO)) == 0;
  sum_splits_kernel<TO><<<stride_blocks(count, vec ? 4 : 1), 256, 0, stream>>>(
      P, S, count, E, out, vec);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tile_gemm
