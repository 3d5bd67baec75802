// K5 and K6: the fused f32 correlation products.
//
//   K5  Q (b,n) = (D·Aᵀ)·A          replaces normal_matvec_fused
//   K6  C (b,n) = (Y − X·Aᵀ)·A      replaces residual_correlation_fused
//
// (sparse_solvers_tpu/ops/pallas/kernels.py:115-157 and :245-290), with A
// (m,n), D and X (b,n), Y (b,m), all f32. The TPU kernels stream A once
// over a sequential row-tile grid while the whole (b,n) output stays
// resident in VMEM. That does not carry over: at b=64, n=8192 the output is
// 2 MiB, far past a block's 227 KB of shared memory, and CUDA blocks run in
// no order, so one pass would need a cross-block reduction (atomics break
// determinism; a split reduction adds a pass anyway).
//
// Here each product is two launches of one tile GEMM from tile_gemm.cuh,
// with no split-K and no atomics, so repeat runs are bit-identical:
//   pass 1  T (b,m) = D·Aᵀ (K6: R = Y − X·Aᵀ, the subtraction in the
//           epilogue) into a scratch;
//   pass 2  Q (b,n) = T·A.
// The precision is the caller's (blas.current_precision(), read by the
// wrapper):
//   "highest"/"high"  gemm_f32_kernel, fp32 FMAs, no TF32 anywhere, T in
//                     f32 (the Pallas kernel maps HIGH to HIGHEST too);
//   "default"         gemm_bf16_kernel, A, D and X rounded to bf16 as they
//                     are staged, T (R) rounded to bf16 in the epilogue,
//                     fp32 sums: what the MXU does at DEFAULT, and what K1
//                     does.
//
// What bounds it on the H100 at m=4096, n=8192 (A is 134 MB of f32, read
// once; data-sheet peaks 3.35 TB/s, 67 TFLOP/s fp32, 989 TFLOP/s bf16):
//   b=8    40 µs, bytes, at either precision (1.07 GFLOP);
//   b=64   128 µs at "highest", operations (8.6 GFLOP of fp32); 41 µs at
//          "default", bytes;
//   b=256  513 µs at "highest", operations (34.4 GFLOP); 45 µs at
//          "default", bytes (A plus 17 MB of D and Q).
// This two-launch form reads A twice and writes and reads T, so it cannot
// reach the bytes bound; the fp32 tiles use the CUDA cores' FMAs. Small
// batches take 16x32 block tiles, so that enough blocks fill the SMs. wgmma,
// TMA and a one-pass design are later work.
//
// Any b, m, n (the wrapper returns early when one is 0): ragged tile edges
// load zeros and store masked.

#include "tile_gemm.cuh"

namespace {

using namespace tile_gemm;

int sm_count() {
  static const int count = [] {
    int dev = 0, c = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    return c;
  }();
  return count;
}

// fp32 C = L·B (or E − L·B): 64x64 tiles of 4x4 per thread when they give
// every SM a block, else 16x32 tiles of 2x2.
template <bool R_NK, bool SUB>
void launch_f32(const float* L, const float* R, float* C, const float* E,
                int M, int N, int K, int ldl, int ldr, int ldc,
                cudaStream_t stream) {
  const long big = (long)((M + 63) / 64) * ((N + 63) / 64);
  if (big >= sm_count()) {
    const dim3 grid((M + 63) / 64, (N + 63) / 64);
    gemm_f32_kernel<64, 64, 4, 4, R_NK, SUB><<<grid, 256, 0, stream>>>(
        L, R, C, E, M, N, K, ldl, ldr, ldc);
  } else {
    const dim3 grid((M + 15) / 16, (N + 31) / 32);
    gemm_f32_kernel<16, 32, 2, 2, R_NK, SUB><<<grid, 128, 0, stream>>>(
        L, R, C, E, M, N, K, ldl, ldr, ldc);
  }
}

// Out (b,n) = T·A with T (b,m) = V·Aᵀ, or Y − V·Aᵀ when SUB.
template <bool SUB>
int fused(const float* V, const float* Y, const float* A, void* T,
          float* Out, int b, int m, int n, int bf16_mode,
          cudaStream_t stream) {
  if (bf16_mode) {
    bf16* T16 = static_cast<bf16*>(T);
    const dim3 grid1((b + BM - 1) / BM, (m + BN - 1) / BN);
    gemm_bf16_kernel<float, float, bf16, true, SUB><<<grid1, THREADS, 0, stream>>>(
        V, A, T16, Y, b, m, n, n, n, m,
        aligned16(V) && n % 4 == 0, aligned16(A) && n % 4 == 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid2((b + BM - 1) / BM, (n + BN - 1) / BN);
    gemm_bf16_kernel<bf16, float, float, false, false><<<grid2, THREADS, 0, stream>>>(
        T16, A, Out, nullptr, b, n, m, m, n, n,
        aligned16(T16) && m % 8 == 0, aligned16(A) && n % 4 == 0);
  } else {
    float* T32 = static_cast<float*>(T);
    launch_f32<true, SUB>(V, A, T32, Y, b, m, n, n, n, m, stream);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    launch_f32<false, false>(T32, A, Out, nullptr, b, n, m, m, n, n, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K5: Q (b,n) = (D·Aᵀ)·A with the (b,m) scratch T (bf16 when bf16_mode,
// else f32). All matrices contiguous row-major f32; b, m, n > 0. Returns
// cudaGetLastError().
int ss_normal_matvec_f32(const float* D, const float* A, void* T, float* Q,
                         int b, int m, int n, int bf16_mode,
                         cudaStream_t stream) {
  return fused<false>(D, nullptr, A, T, Q, b, m, n, bf16_mode, stream);
}

// K6: C (b,n) = (Y − X·Aᵀ)·A with the (b,m) scratch R, as K5.
int ss_residual_correlation_f32(const float* X, const float* Y,
                                const float* A, void* R, float* C, int b,
                                int m, int n, int bf16_mode,
                                cudaStream_t stream) {
  return fused<true>(X, Y, A, R, C, b, m, n, bf16_mode, stream);
}

}  // extern "C"
