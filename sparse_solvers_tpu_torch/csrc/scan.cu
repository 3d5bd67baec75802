// K2: the homotopy step-size scan — per lane, the leftmost minimum over
// the γ candidates.
//
// Replaces the Pallas TPU kernel find_max_gamma_fused
// (sparse_solvers_tpu/ops/pallas/scan.py:45-152; reference:
// homotopy-cpu.cpp:100-164). Per lane, over two candidate sets:
//   inactive i (mask 0):  (c_inf−c_i)/(1−q_i) and (c_inf+c_i)/(1+q_i), each
//                         valid iff its denominator ≠ 0 and 0 < t < FLT_MAX
//   active slot s:        −x_act[s]/d_act[s], valid iff 0 < t < FLT_MAX, at
//                         position indices[s]
// the lexicographically least (value, position) pair; a lane with no valid
// candidate returns (FLT_MAX, 0), the reference's running-min start.
//
// What bounds it on the H100: it is a streaming pass, 9 bytes per element
// (q, c f32 and the int8 mask): 19 MB at b=256, n=8192, about 6 µs of HBM
// time. One block per lane; its threads stride over n with coalesced
// loads, each carrying a (value, int32 position) pair, and the block folds
// the pairs with warp shuffles and one shared-memory round — every step of
// it lexicographic, so ties go to the leftmost position whatever the order
// of the partial results. The K active candidates fold into the same pairs.
// Positions are int32: the TPU kernel's exact-f32 positions (n < 2²⁴) were
// a Mosaic limitation.
//
// Build without --use_fast_math: padding slots give 0/0 = NaN, which must
// fail both comparisons, and the divisions must round as IEEE divisions do
// in the plain version.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void lexmin(float& v, int& p, float ov, int op) {
  if (ov < v || (ov == v && op < p)) {
    v = ov;
    p = op;
  }
}

__device__ __forceinline__ void warp_lexmin(float& v, int& p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int op = __shfl_down_sync(0xffffffffu, p, off);
    lexmin(v, p, ov, op);
  }
}

__global__ void __launch_bounds__(THREADS)
find_max_gamma_kernel(const float* __restrict__ q, const float* __restrict__ c,
                      const int8_t* __restrict__ mask,
                      const float* __restrict__ c_inf,
                      const float* __restrict__ x_act,
                      const float* __restrict__ d_act,
                      const int* __restrict__ indices,
                      float* __restrict__ gamma, int* __restrict__ idx,
                      int n, int K) {
  const float big = FLT_MAX;
  const size_t lane = blockIdx.x;
  const float ci = c_inf[lane];
  const float* ql = q + lane * n;
  const float* cl = c + lane * n;
  const int8_t* ml = mask + lane * n;

  float v = big;
  int p = 0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    if (ml[i] > 0) continue;  // active coordinate: no inactive candidate
    const float qi = ql[i], cv = cl[i];
    const float dl = 1.0f - qi, dr = 1.0f + qi;
    const float tl = (ci - cv) / dl, tr = (ci + cv) / dr;
    const float a = (dl != 0.0f && tl > 0.0f && tl < big) ? tl : big;
    const float b = (dr != 0.0f && tr > 0.0f && tr < big) ? tr : big;
    const float t = fminf(a, b);
    if (t < big) lexmin(v, p, t, i);
  }
  const float* xa = x_act + lane * K;
  const float* da = d_act + lane * K;
  const int* ia = indices + lane * K;
  for (int s = threadIdx.x; s < K; s += THREADS) {
    const float t = -xa[s] / da[s];
    if (t > 0.0f && t < big) lexmin(v, p, t, ia[s]);
  }

  __shared__ float sv[THREADS / 32];
  __shared__ int sp[THREADS / 32];
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  warp_lexmin(v, p);
  if (l == 0) {
    sv[w] = v;
    sp[w] = p;
  }
  __syncthreads();
  if (w == 0) {
    v = l < THREADS / 32 ? sv[l] : big;
    p = l < THREADS / 32 ? sp[l] : 0;
    warp_lexmin(v, p);
    if (l == 0) {
      gamma[lane] = v;
      idx[lane] = p;
    }
  }
}

}  // namespace

extern "C" {

// gamma (b,) f32 and idx (b,) int32 from q, c (b,n) f32, mask (b,n) int8,
// c_inf (b,) f32, x_act, d_act (b,K) f32, indices (b,K) int32; all
// contiguous, b > 0. Returns cudaGetLastError().
int ss_find_max_gamma(const float* q, const float* c, const int8_t* mask,
                      const float* c_inf, const float* x_act,
                      const float* d_act, const int* indices, float* gamma,
                      int* idx, int b, int n, int K, cudaStream_t stream) {
  find_max_gamma_kernel<<<b, THREADS, 0, stream>>>(
      q, c, mask, c_inf, x_act, d_act, indices, gamma, idx, n, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
