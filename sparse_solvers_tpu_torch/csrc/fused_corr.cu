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
// no order, so one pass would need a cross-block reduction anyway.
//
// Here each product is two passes: T (b,m) = D·Aᵀ (K6: Y − X·Aᵀ), then
// Out (b,n) = T·A. The precision is the caller's (blas.current_precision(),
// read by the wrapper):
//   "highest"/"high"  tile_gemm.cuh's f32ring::gemm_f32_async_kernel: fp32
//                     FMAs, no TF32 anywhere, T in f32 (the Pallas kernel
//                     maps HIGH to HIGHEST too);
//   "default"         K1's ring::gemm_bf16_async_kernel (its 128x64 tile
//                     widened to 128x128 at the largest batch tile) on
//                     bf16(A) and bf16(D) (bf16(X)), rounded per call into
//                     scratches by round_to_bf16_kernel, T rounded to bf16
//                     after the sum, fp32 sums: what the MXU does at
//                     DEFAULT, and what K1 does. No bf16 copy of A is kept
//                     between calls.
//
// What bounds them on the H100 at m=4096, n=8192 (A is 134 MB of f32;
// data-sheet peaks 3.35 TB/s, 67 TFLOP/s fp32, 989 TFLOP/s bf16):
//   b=8    40 µs, bytes, at either precision (1.07 GFLOP);
//   b=64   128 µs at "highest", operations (8.6 GFLOP of fp32); 41 µs at
//          "default", bytes;
//   b=256  513 µs at "highest", operations (34.4 GFLOP); 45 µs at
//          "default", bytes (A plus 17 MB of D and Q).
// The two-pass form reads A twice (and "default" reads it once more to
// round it), so it cannot reach the bytes bound. What the design does:
//   * fewer shared loads per FMA: each fp32 thread holds an 8x8 tile of
//     outputs (2x8 at the batch tile of 16) and reads both operands as
//     float4, so four depth steps cost 16 shared loads for 256 FMAs;
//   * a ring to hide latency: slices k+1.. are in flight as cp.async
//     copies (16-byte, f32 as it is) while slice k is multiplied;
//   * split-K to fill the 132 SMs: T (b,m) is small while its depth n is
//     large, so pass 1 alone would run 32 to 128 blocks. A pass that would
//     launch fewer than 132 blocks splits its depth into S fixed ranges
//     (ops/cuda/kernels.py::fused_launch_plan picks the batch tile and S
//     from b, m, n and the precision); each split writes f32 partials
//     into an (S, b, ·) scratch and sum_splits_kernel adds them in the
//     order s = 0..S-1, then applies K6's Y − Σ (after the full sum, as in
//     the twin) and rounds T to bf16 at "default". With S = 1 a pass
//     writes its result directly (K6's subtraction in the fp32 epilogue),
//     except pass 1 at "default", whose sum rounds T. No atomics: repeat
//     runs are bit-identical.
//
// Any b, m, n (the wrapper returns early when one is 0): ragged tile edges
// load zeros and store masked.

#include "tile_gemm.cuh"

namespace {

using namespace tile_gemm;

// the batch tiles (lanes per block) the launch plan picks from, at either
// precision
constexpr int BATCH_TILE_SMALL = 16;
constexpr int BATCH_TILE_MID = 64;
constexpr int BATCH_TILE_LARGE = 128;
// the bf16 ring's column tile: K1's 64, and 128 at the largest batch tile,
// where a wider tile stages a third fewer bytes per product
constexpr int RING_BN_LARGE = 128;
// its slices: 64 deep (whole 128-byte lines a row), three in the ring
// (K1 keeps 32 and four)
constexpr int RING_BK = 64;
constexpr int RING_STAGES = 3;

constexpr int ring_bn(int tile) {
  return tile == BATCH_TILE_LARGE ? RING_BN_LARGE : ring::BN;
}

// pass 1's and pass 2's splits and depth per split (a multiple of BK)
struct Splits {
  int s1, c1, s2, c2;
};

// "highest": T = V·Aᵀ (Y − V·Aᵀ) in f32, then Out = T·A. With one split a
// pass writes its result directly; else its partials go through P1 or P2.
template <int BM>
cudaError_t fused_f32(const float* V, const float* Y, const float* A,
                      float* P1, float* T, float* P2, float* Out, int b,
                      int m, int n, Splits sp, cudaStream_t st) {
  namespace f = f32ring;
  const bool one1 = sp.s1 == 1, one2 = sp.s2 == 1;
  cudaError_t err = f::launch<BM, true>(V, A, one1 ? T : P1, one1 ? Y : nullptr,
                                        b, m, n, n, n, m, sp.s1, sp.c1, st);
  if (err == cudaSuccess && !one1)
    err = sum_splits(P1, sp.s1, (size_t)b * m, Y, T, st);
  if (err != cudaSuccess) return err;
  err = f::launch<BM, false>(T, A, one2 ? Out : P2, nullptr, b, n, m, m, n, n,
                             sp.s2, sp.c2, st);
  if (err == cudaSuccess && !one2)
    err = sum_splits(P2, sp.s2, (size_t)b * n, nullptr, Out, st);
  return err;
}

// "default": A16 = bf16(A) and V16 = bf16(V) in one launch; P1 (S1,b,m) =
// V16·A16ᵀ in f32; T16 = bf16(Σ P1) (bf16(Y − Σ P1)); Out = T16·A16,
// through P2 when split.
template <int TBM>
cudaError_t fused_bf16(const float* V, const float* Y, const float* A,
                       bf16* A16, bf16* V16, float* P1, bf16* T16, float* P2,
                       float* Out, int b, int m, int n, Splits sp,
                       cudaStream_t st) {
  namespace r = ring;
  constexpr int TBN = ring_bn(TBM);
  const bool one2 = sp.s2 == 1;
  cudaError_t err =
      round_to_bf16(A, A16, (size_t)m * n, st, V, V16, (size_t)b * n);
  if (err == cudaSuccess)
    err = r::launch_ring<float, true, TBM, TBN, RING_BK, RING_STAGES, true>(
        V16, A16, P1, b, m, n, n, n, m, sp.s1, sp.c1, st);
  if (err == cudaSuccess)
    err = sum_splits(P1, sp.s1, (size_t)b * m, Y, T16, st);
  if (err == cudaSuccess)
    err = r::launch_ring<float, false, TBM, TBN, RING_BK, RING_STAGES, true>(
        T16, A16, one2 ? Out : P2, b, n, m, m, n, n, sp.s2, sp.c2, st);
  if (err == cudaSuccess && !one2)
    err = sum_splits(P2, sp.s2, (size_t)b * n, nullptr, Out, st);
  return err;
}

template <int TILE>
cudaError_t fused_at(const float* V, const float* Y, const float* A,
                     void* A16, void* V16, float* P1, void* T, float* P2,
                     float* Out, int b, int m, int n, int bf16_mode,
                     Splits sp, cudaStream_t st) {
  if (bf16_mode)
    return fused_bf16<TILE>(V, Y, A, static_cast<bf16*>(A16),
                            static_cast<bf16*>(V16), P1,
                            static_cast<bf16*>(T), P2, Out, b, m, n, sp, st);
  return fused_f32<TILE>(V, Y, A, P1, static_cast<float*>(T), P2, Out, b, m,
                         n, sp, st);
}

int fused(const float* V, const float* Y, const float* A, void* A16,
          void* V16, float* P1, void* T, float* P2, float* Out, int b, int m,
          int n, int bf16_mode, int tile, Splits sp, cudaStream_t st) {
  if (sp.s1 < 1 || sp.s2 < 1 || sp.c1 < 1 || sp.c2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tile) {
    case BATCH_TILE_SMALL:
      return static_cast<int>(fused_at<BATCH_TILE_SMALL>(
          V, Y, A, A16, V16, P1, T, P2, Out, b, m, n, bf16_mode, sp, st));
    case BATCH_TILE_MID:
      return static_cast<int>(fused_at<BATCH_TILE_MID>(
          V, Y, A, A16, V16, P1, T, P2, Out, b, m, n, bf16_mode, sp, st));
    case BATCH_TILE_LARGE:
      return static_cast<int>(fused_at<BATCH_TILE_LARGE>(
          V, Y, A, A16, V16, P1, T, P2, Out, b, m, n, bf16_mode, sp, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// K5: Q (b,n) = (D·Aᵀ)·A. The launch plan (ops/cuda/kernels.py::
// fused_launch_plan) gives the batch tile, each pass's splits s and depth
// per split c, and the scratches: A16 (m,n) and D16 (b,n) bf16 at
// "default" (bf16_mode), P1 (s1,b,m) f32, T (b,m) (bf16 at "default", else
// f32), P2 (s2,b,n) f32; a scratch the plan does not use may be null. All
// matrices contiguous row-major; b, m, n > 0. Returns the first non-zero
// cudaGetLastError() of the launches, or 0.
int ss_normal_matvec_f32(const float* D, const float* A, void* A16,
                         void* D16, float* P1, void* T, float* P2, float* Q,
                         int b, int m, int n, int bf16_mode, int tile,
                         int s1, int c1, int s2, int c2,
                         cudaStream_t stream) {
  return fused(D, nullptr, A, A16, D16, P1, T, P2, Q, b, m, n, bf16_mode,
               tile, Splits{s1, c1, s2, c2}, stream);
}

// K6: C (b,n) = (Y − X·Aᵀ)·A, with K5's plan and scratches (X in D's place).
int ss_residual_correlation_f32(const float* X, const float* Y,
                                const float* A, void* A16, void* X16,
                                float* P1, void* R, float* P2, float* C,
                                int b, int m, int n, int bf16_mode, int tile,
                                int s1, int c1, int s2, int c2,
                                cudaStream_t stream) {
  return fused(X, Y, A, A16, X16, P1, R, P2, C, b, m, n, bf16_mode, tile,
               Splits{s1, c1, s2, c2}, stream);
}

}  // extern "C"
