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
// first form is simple: tile_gemm.cuh's gemm_bf16_kernel, 64x64 block tiles,
// four warps of 32x32, one synchronous shared-memory stage per 32-deep
// slice. Blocks that share an A16
// tile are adjacent in launch order (the batch tiles run along blockIdx.x),
// so the second and later reads of each tile tend to hit L2. wgmma, TMA
// and a multi-stage pipeline are later work.
//
// Any b, m, n: ragged tile edges load zeros and store masked.

#include "tile_gemm.cuh"

using tile_gemm::aligned16;
using tile_gemm::bf16;
using tile_gemm::gemm_bf16_kernel;

extern "C" {

// Q (b,n) f32 = bf16(bf16(D)·A16ᵀ)·A16 with the (b,m) bf16 scratch P.
// All matrices contiguous row-major; b, m, n > 0. Returns cudaGetLastError().
int ss_normal_matvec_bf16(const float* D, const bf16* A16, bf16* P, float* Q,
                          int b, int m, int n, cudaStream_t stream) {
  using tile_gemm::BM;
  using tile_gemm::BN;
  const dim3 block(tile_gemm::THREADS);
  const dim3 grid1((b + BM - 1) / BM, (m + BN - 1) / BN);
  gemm_bf16_kernel<float, bf16, bf16, true, false><<<grid1, block, 0, stream>>>(
      D, A16, P, nullptr, b, m, n, n, n, m,
      aligned16(D) && n % 4 == 0, aligned16(A16) && n % 8 == 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((b + BM - 1) / BM, (n + BN - 1) / BN);
  gemm_bf16_kernel<bf16, bf16, float, false, false><<<grid2, block, 0, stream>>>(
      P, A16, Q, nullptr, b, n, m, m, n, n,
      aligned16(P) && m % 8 == 0, aligned16(A16) && n % 8 == 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
