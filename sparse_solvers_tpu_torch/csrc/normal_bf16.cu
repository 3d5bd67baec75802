// K1: q = AᵀA·d for a batch of slot directions, bf16 operands, fp32 sums.
//
// Replaces the Pallas TPU kernel normal_matvec_fused_bf16
// (sparse_solvers_tpu/ops/pallas/kernels.py:160-241): Q = bf16(bf16(D)·A16ᵀ)·A16
// with D (b,n) f32, A16 (m,n) bf16, Q (b,n) f32. The TPU kernel streams A16
// once over a sequential row-tile grid while the whole (b,n) f32 output
// stays resident in VMEM. That decomposition does not carry over: at the
// main-path shape the output is 8 MiB, no SM holds it, and CUDA blocks run
// in no order.
//
// Here the product is two launches of one tile GEMM on the bf16 tensor
// cores (WMMA 16x16x16, fp32 accumulators), deterministic, no split-K:
//   pass 1  P (b,m) = D·A16ᵀ, D rounded to bf16 as it is staged, P rounded
//           to bf16 in the epilogue (the TPU kernel's intermediate round);
//   pass 2  Q (b,n) = P·A16, written in f32.
// What bounds it on the H100: at b=256, m=4096, n=8192 one call is 34 GFLOP
// and reads A16 (64 MiB) twice — about 35 µs of bf16 tensor-core time and
// 40 µs of HBM time at the data-sheet peaks, so the call is balanced. This
// first form is simple: 64x64 block tiles, four warps of 32x32, one
// synchronous shared-memory stage per 32-deep slice. Blocks that share an A16
// tile are adjacent in launch order (the batch tiles run along blockIdx.x),
// so the second and later reads of each tile tend to hit L2. wgmma, TMA
// and a multi-stage pipeline are later work.
//
// Any b, m, n: ragged tile edges load zeros and store masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

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

// C (M,N) = L (M,K) · B (K,N). L is row-major with leading dimension ldl.
// R_NK: R is stored (N,K) row-major (B = Rᵀ, the pass-1 layout of A16);
// otherwise R is stored (K,N) row-major (B = R, the pass-2 layout).
template <typename TL, typename TC, bool R_NK>
__global__ void __launch_bounds__(THREADS)
gemm_bf16_kernel(const TL* __restrict__ L, const bf16* __restrict__ R,
                 TC* __restrict__ C, int M, int N, int K,
                 int ldl, int ldr, int ldc, bool vec_l, bool vec_r) {
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
    if (gr < M && gc < N) store_out(&C[(size_t)gr * ldc + gc], Cs[r * LDC + c]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Q (b,n) f32 = bf16(bf16(D)·A16ᵀ)·A16 with the (b,m) bf16 scratch P.
// All matrices contiguous row-major; b, m, n > 0. Returns cudaGetLastError().
int ss_normal_matvec_bf16(const float* D, const bf16* A16, bf16* P, float* Q,
                          int b, int m, int n, cudaStream_t stream) {
  const dim3 block(THREADS);
  const dim3 grid1((b + BM - 1) / BM, (m + BN - 1) / BN);
  gemm_bf16_kernel<float, bf16, true><<<grid1, block, 0, stream>>>(
      D, A16, P, b, m, n, n, n, m,
      aligned16(D) && n % 4 == 0, aligned16(A16) && n % 8 == 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((b + BM - 1) / BM, (n + BN - 1) / BN);
  gemm_bf16_kernel<bf16, float, false><<<grid2, block, 0, stream>>>(
      P, A16, Q, b, n, m, m, n, n,
      aligned16(P) && m % 8 == 0, aligned16(A16) && n % 8 == 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
