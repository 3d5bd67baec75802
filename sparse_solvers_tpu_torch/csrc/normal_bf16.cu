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
// Here the product is three launches on the caller's stream, deterministic,
// no split-K and no atomics:
//   round   D16 (b,n) = bf16(D), round to nearest even (D.to(bfloat16)):
//           a cp.async copy cannot convert, so D becomes bf16 once here
//           instead of on every staging (12.6 MB moved at the main shape);
//   pass 1  P (b,m) = D16·A16ᵀ, P rounded to bf16 in the epilogue (the TPU
//           kernel's intermediate round);
//   pass 2  Q (b,n) = P·A16, written in f32.
// Both passes are tile_gemm.cuh's ring::gemm_bf16_async_kernel: 128x64
// block tiles (128 batch lanes) of eight warps of 32x32, fed by a
// four-stage ring of cp.async copies, so slices k+1..k+3 are in flight
// while slice k is multiplied. The warps multiply with mma.sync on
// fragments that ldmatrix reads: WMMA's load_matrix_sync compiles to
// 32-bit shared loads on sm_90a and took about twice the compute time. At
// b=256, m=4096, n=8192 pass 1 runs 2x64 = 128 blocks and pass 2 2x128 =
// 256, which fill the 132 SMs without split-K (a 128x128 tile would leave
// pass 1 with 64). Blocks that share an A16 tile are adjacent in launch
// order (the batch tiles run along blockIdx.x), so the second read of each
// tile tends to hit L2.
//
// What bounds it on the H100: at the main-path shape one call is 34.4 GFLOP
// — about 35 µs of bf16 tensor-core time at the 989 TFLOP/s data-sheet
// peak — and this two-pass form reads A16 (64 MiB) twice, about 40 µs of
// HBM time at 3.35 TB/s. The ring and the larger tile replace the earlier
// 64x64 tile with one synchronous stage, which exposed the full load
// latency of every slice and re-read D as f32 on each staging. Left for the
// next redesign: wgmma fed by TMA with a producer warp, persistent tiles,
// and a form that reads A16 once.
//
// Any b, m, n: ragged tile edges load zeros and store masked.

#include "tile_gemm.cuh"

extern "C" {

// Q (b,n) f32 = bf16(bf16(D)·A16ᵀ)·A16 with the bf16 scratches D16 (b,n)
// and P (b,m). All matrices contiguous row-major; b, m, n > 0. Returns the
// first non-zero cudaGetLastError() of the three launches, or 0.
int ss_normal_matvec_bf16(const float* D, const tile_gemm::bf16* A16,
                          tile_gemm::bf16* D16, tile_gemm::bf16* P, float* Q,
                          int b, int m, int n, cudaStream_t stream) {
  namespace ring = tile_gemm::ring;
  cudaError_t err = tile_gemm::round_to_bf16(D, D16, (size_t)b * n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = ring::launch_ring<tile_gemm::bf16, true>(D16, A16, P, b, m, n, n, n,
                                                 m, 1, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(ring::launch_ring<float, false>(
      P, A16, Q, b, n, m, m, n, n, 1, m, stream));
}

}  // extern "C"
