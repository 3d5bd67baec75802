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
// Here the product is three launches on the caller's stream (four where
// the first pass splits its depth), deterministic, no atomics:
//   round   D16 (b,n) = bf16(D), round to nearest even (D.to(bfloat16)):
//           a tile copy cannot convert, so D becomes bf16 once here
//           instead of on every staging (12.6 MB moved at the main shape);
//   pass 1  P (b,m) = D16·A16ᵀ, P rounded to bf16 in the epilogue (the TPU
//           kernel's intermediate round);
//   pass 2  Q (b,n) = P·A16, written in f32.
//
// Two routes (ops/cuda/kernels.py::k1_launch_plan picks one and its tiles;
// this entry takes the plan's numbers as they are):
//
//   "wgmma" wgmma_gemm.cuh's wg::gemm_bf16_async_kernel, wherever TMA can
//           describe the operands (m and n multiples of 8, A16 on 16
//           bytes): a producer warp keeps TMA loads of 64-deep slices in
//           flight, two consumer warpgroups multiply them with wgmma. The
//           batch tile holds the whole batch (256 lanes at b=256), so each
//           A16 tile leaves L2 or HBM once a pass; tools/probe_k1_ring.py
//           found the ring's L2 staging of 128x64 tiles, each A16 tile once
//           per 128 lanes, to be most of its time. Pass 2 reads A16 (m,n) as
//           wgmma's transposed B, so neither pass copies A16. Where pass
//           1's output (b,m) has too few tiles to fill the 132 SMs (the
//           gram-free shape, 256x2048 over a depth of 65536), the plan
//           splits its depth into S ranges whose f32 partials live in Q's
//           storage (S·m ≤ n: Q is dead until pass 2 writes it, so no
//           scratch is added), and
//           wg::gemm_bf16_async_kernel_split_sum adds them in the order
//           z = 0..S-1 and rounds to bf16 as the unsplit epilogue does.
//   "ring"  tile_gemm.cuh's ring::gemm_bf16_async_kernel, for shapes
//           or pointers TMA cannot describe (m or n not a multiple of 8,
//           A16 off 16 bytes): 128x64 block tiles of eight warps of 32x32
//           on ldmatrix + mma.sync, fed by a four-stage ring of cp.async
//           copies. The wrapper counts these launches
//           (ops/dispatch.fallbacks).
//
// Every launch's kernel name holds "round_to_bf16_kernel" or
// "gemm_bf16_async_kernel": perfbench/metrics/k1_roofline.py and
// torch_ops.device_ms_per_iter.py attribute K1's device time by those
// substrings.
//
// What bounds it on the H100: at b=256, m=4096, n=8192 one call is 34.4
// GFLOP, 0.0347 ms of bf16 tensor-core time at the 989 TFLOP/s data-sheet
// peak, and this two-pass form reads A16 (64 MiB) twice, about 40 µs of
// HBM time at 3.35 TB/s; at m=2048, n=65536 the bound is 0.1390 ms (137
// GFLOP). The yardstick counts A16 read once, so the two reads cap the
// share of the bound near 77 % and 69 %. Left for a later redesign:
// persistent tiles, clusters that multicast the batch tile, and a form
// that reads A16 once.
//
// Any b, m, n: ragged tile edges load zeros and store masked.

#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

// The wgmma route: maps of D16 and P in boxes of bm rows, of A16 as
// pass 1's (N,K) operand in boxes of bn1 rows and as pass 2's (K,N) one in
// 64x64 boxes; pass 1 over `splits` depth ranges of `chunk` (partials in
// Q, then summed into P) or straight into P.
cudaError_t normal_wgmma(const tile_gemm::bf16* D16,
                         const tile_gemm::bf16* A16, tile_gemm::bf16* P,
                         float* Q, int b, int m, int n, int bm, int bn1,
                         int splits, int chunk, int bn2,
                         cudaStream_t stream) {
  namespace wg = tile_gemm::wg;
  CUtensorMap d16, a_nk, p, a_kn;
  cudaError_t err = wg::encode(&d16, D16, b, n, bm);
  if (err == cudaSuccess) err = wg::encode(&a_nk, A16, m, n, bn1);
  if (err == cudaSuccess) err = wg::encode(&p, P, b, m, bm);
  if (err == cudaSuccess) err = wg::encode(&a_kn, A16, m, n, wg::BK);
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    err = wg::launch<false>(bm, bn1, d16, a_nk, Q, false, b, m, n, m, splits,
                            chunk, stream);
    if (err == cudaSuccess)
      err = wg::split_sum(Q, splits, (size_t)b * m, P, stream);
  } else {
    err = wg::launch<false>(bm, bn1, d16, a_nk, P, true, b, m, n, m, 1, n,
                            stream);
  }
  if (err != cudaSuccess) return err;
  return wg::launch<true>(bm, bn2, p, a_kn, Q, false, b, n, m, n, 1, m,
                          stream);
}

}  // namespace

extern "C" {

// Q (b,n) f32 = bf16(bf16(D)·A16ᵀ)·A16 with the bf16 scratches D16 (b,n)
// and P (b,m). All matrices contiguous row-major; b, m, n > 0. `wgmma`
// 1 takes the wgmma route with the plan's batch tile bm, column tiles bn1
// and bn2 and pass 1's splits of chunk, 0 the ring (the rest unread).
// Returns the first non-zero error of the launches (or of encoding the
// tensor maps), or 0.
int ss_normal_matvec_bf16(const float* D, const tile_gemm::bf16* A16,
                          tile_gemm::bf16* D16, tile_gemm::bf16* P, float* Q,
                          int b, int m, int n, int wgmma, int bm, int bn1,
                          int splits, int chunk, int bn2,
                          cudaStream_t stream) {
  namespace ring = tile_gemm::ring;
  cudaError_t err = tile_gemm::round_to_bf16(D, D16, (size_t)b * n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (wgmma)
    return static_cast<int>(normal_wgmma(D16, A16, P, Q, b, m, n, bm, bn1,
                                         splits, chunk, bn2, stream));
  err = ring::launch_ring<tile_gemm::bf16, true>(D16, A16, P, b, m, n, n, n,
                                                 m, 1, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(ring::launch_ring<float, false>(
      P, A16, Q, b, n, m, m, n, n, 1, m, stream));
}

}  // extern "C"
