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

#include <atomic>

#include "tile_gemm.cuh"

namespace {

using tile_gemm::aligned16;
using tile_gemm::bf16;

// y = bf16(x), round to nearest even, four at a time when `vec` (x 16-byte
// and y 8-byte aligned).
__global__ void round_to_bf16_kernel(const float* __restrict__ x,
                                     bf16* __restrict__ y, size_t count,
                                     bool vec) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t tail = 0;
  if (vec) {
    for (size_t i = first; i < count / 4; i += stride) {
      const float4 v = reinterpret_cast<const float4*>(x)[i];
      tile_gemm::store4(y + 4 * i, reinterpret_cast<const float*>(&v));
    }
    tail = count / 4 * 4;
  }
  for (size_t i = tail + first; i < count; i += stride)
    y[i] = __float2bfloat16_rn(x[i]);
}

// C = L·B on the ring kernel; sets its shared-memory attribute once per
// instantiation and device before the first launch.
template <typename TC, bool R_NK>
cudaError_t launch_ring(const bf16* L, const bf16* R, TC* C, int M, int N,
                        int K, int ldl, int ldr, int ldc, cudaStream_t stream) {
  namespace ring = tile_gemm::ring;
  static std::atomic<unsigned long long> ready{0};  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(ring::gemm_bf16_async_kernel<TC, R_NK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ring::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit);
  }
  const size_t c_align = sizeof(TC) * 4;  // a four-element store
  const bool vec_c = (reinterpret_cast<uintptr_t>(C) % c_align) == 0 &&
                     ldc % 4 == 0;
  const dim3 grid((M + ring::BM - 1) / ring::BM, (N + ring::BN - 1) / ring::BN);
  ring::gemm_bf16_async_kernel<TC, R_NK>
      <<<grid, ring::THREADS, ring::SMEM_BYTES, stream>>>(
          L, R, C, M, N, K, ldl, ldr, ldc, aligned16(L) && ldl % 8 == 0,
          aligned16(R) && ldr % 8 == 0, vec_c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Q (b,n) f32 = bf16(bf16(D)·A16ᵀ)·A16 with the bf16 scratches D16 (b,n)
// and P (b,m). All matrices contiguous row-major; b, m, n > 0. Returns the
// first non-zero cudaGetLastError() of the three launches, or 0.
int ss_normal_matvec_bf16(const float* D, const bf16* A16, bf16* D16,
                          bf16* P, float* Q, int b, int m, int n,
                          cudaStream_t stream) {
  // four elements a thread, at most 4096 blocks striding over the rest
  const size_t count = (size_t)b * n;
  const size_t want = (count / 4 + 255) / 256 + 1;
  const unsigned blocks = want < 4096 ? (unsigned)want : 4096u;
  round_to_bf16_kernel<<<blocks, 256, 0, stream>>>(
      D, D16, count,
      aligned16(D) && reinterpret_cast<uintptr_t>(D16) % 8 == 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_ring<bf16, true>(D16, A16, P, b, m, n, n, n, m, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_ring<float, false>(P, A16, Q, b, n, m, m, n, n, stream));
}

}  // extern "C"
