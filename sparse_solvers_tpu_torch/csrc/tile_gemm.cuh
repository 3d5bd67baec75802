// Tile GEMMs shared by K1 (normal_bf16.cu), K5 and K6 (fused_corr.cu).
//
// C (M,N) = L (M,K) · B (K,N), every matrix row-major. B comes from a
// matrix R that is stored either (N,K) (R_NK: B = Rᵀ, how the first pass of
// a normal product reads A) or (K,N) (B = R, how the second pass reads it).
// With SUB the epilogue writes E − L·B instead, E (M,N) with C's leading
// dimension (K6's residual Y − X·Aᵀ). No split-K and no atomics: each output
// is one block's fixed-order sum, so repeat runs are bit-identical.
//
//   gemm_bf16_kernel  bf16 tensor cores (WMMA 16x16x16, fp32 accumulators),
//                     64x64 block tiles, four warps of 32x32, one
//                     synchronous 32-deep shared-memory stage. f32 operands
//                     are rounded to bf16 as they are staged, so no bf16
//                     copy of them is ever written; a bf16 C is rounded in
//                     the epilogue.
//   gemm_f32_kernel   fp32 FMAs on the CUDA cores (no TF32), BMxBN block
//                     tiles of TMxTN per thread, a 16-deep shared stage.
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
