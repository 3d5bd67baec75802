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
// time; and two IEEE divisions per position, about 4 µs of this kernel's
// device time there (tools/probe_k2_k4.py). To stream, the card needs many
// bytes in flight, so:
//   * each lane's n positions are split into S contiguous chunks, one CTA
//     each (S from ops/cuda/scan.py::scan_launch_plan: enough CTAs to fill
//     the 132 SMs twice, at most 8), and the S CTAs of a lane run as one
//     thread-block cluster; CTAs of 256 threads keep the grid in one wave;
//   * where n % 4 == 0 and the bases are aligned, a thread reads q and c
//     as float4 and the mask as one 32-bit word per 4 positions, UNROLL of
//     each before it computes (scalar loads otherwise). Four in flight, or
//     four staged through shared memory by cp.async, measured slower;
//   * each CTA folds its chunk to one (value, int32 position) pair with
//     warp shuffles and one shared-memory round; after cluster.sync(), CTA
//     rank 0 reads the S pairs through distributed shared memory and
//     folds them, with the K active-slot candidates it folded itself.
// Every fold is the lexicographic minimum, which is exact and does not
// depend on the order of the partial results, so ties go to the leftmost
// position wherever the chunk boundaries fall. No atomics and no scratch.
// Positions are int32: the TPU kernel's exact-f32 positions (n < 2²⁴) were
// a Mosaic limitation.
//
// Build without --use_fast_math: padding slots give 0/0 = NaN, which must
// fail both comparisons, and the divisions must round as IEEE divisions do
// in the plain version. Positions with mask > 0 skip the divisions.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// ops/cuda/scan.py's plan states the same constants
constexpr int MAX_THREADS = 256;
constexpr int MAX_SPLITS = 8;  // the portable cluster size
constexpr int UNROLL = 2;      // float4 pairs a thread has in flight

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

// Fold inactive position i's candidate into (v, p).
__device__ __forceinline__ void candidate(float ci, float qi, float cv,
                                          int8_t m, int i, float& v, int& p) {
  if (m > 0) return;  // active coordinate: no inactive candidate
  const float big = FLT_MAX;
  const float dl = 1.0f - qi, dr = 1.0f + qi;
  const float tl = (ci - cv) / dl, tr = (ci + cv) / dr;
  const float a = (dl != 0.0f && tl > 0.0f && tl < big) ? tl : big;
  const float b = (dr != 0.0f && tr > 0.0f && tr < big) ? tr : big;
  const float t = fminf(a, b);
  if (t < big) lexmin(v, p, t, i);
}

// The four positions 4f .. 4f+3, the mask's bytes in memory order.
__device__ __forceinline__ void candidates4(float ci, float4 q, float4 c,
                                            uint32_t m, int i, float& v,
                                            int& p) {
  candidate(ci, q.x, c.x, static_cast<int8_t>(m), i, v, p);
  candidate(ci, q.y, c.y, static_cast<int8_t>(m >> 8), i + 1, v, p);
  candidate(ci, q.z, c.z, static_cast<int8_t>(m >> 16), i + 2, v, p);
  candidate(ci, q.w, c.w, static_cast<int8_t>(m >> 24), i + 3, v, p);
}

// Grid (b·S): the S consecutive CTAs of a cluster scan one lane, CTA rank r
// positions [r·chunk, min(n, (r+1)·chunk)). vec, the positions a load: 4
// where n, chunk and the bases allow float4 / 32-bit loads, else 1.
__global__ void __launch_bounds__(MAX_THREADS)
gamma_scan_cluster_kernel(const float* __restrict__ q,
                          const float* __restrict__ c,
                          const int8_t* __restrict__ mask,
                          const float* __restrict__ c_inf,
                          const float* __restrict__ x_act,
                          const float* __restrict__ d_act,
                          const int* __restrict__ indices,
                          float* __restrict__ gamma, int* __restrict__ idx,
                          int n, int K, int chunk, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t lane = blockIdx.x / splits;
  const int tid = threadIdx.x, T = blockDim.x;
  const float big = FLT_MAX;
  const float ci = c_inf[lane];
  const int lo = rank * chunk, hi = min(n, lo + chunk);

  float v = big;
  int p = 0;
  if (vec == 4) {
    const float4* q4 = reinterpret_cast<const float4*>(q + lane * n);
    const float4* c4 = reinterpret_cast<const float4*>(c + lane * n);
    const uint32_t* m4 = reinterpret_cast<const uint32_t*>(mask + lane * n);
    const int f1 = hi / 4;
    for (int f = lo / 4 + tid; f < f1; f += UNROLL * T) {
      // every pair in flight before any is used
      float4 qv[UNROLL], cv[UNROLL];
      uint32_t mv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int g = f + u * T;
        mv[u] = 0x01010101u;  // past the chunk: all active, nothing to fold
        if (g < f1) {
          qv[u] = __ldg(q4 + g);
          cv[u] = __ldg(c4 + g);
          mv[u] = __ldg(m4 + g);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        candidates4(ci, qv[u], cv[u], mv[u], 4 * (f + u * T), v, p);
    }
  } else {
    const float* ql = q + lane * n;
    const float* cl = c + lane * n;
    const int8_t* ml = mask + lane * n;
    for (int i = lo + tid; i < hi; i += T)
      candidate(ci, __ldg(ql + i), __ldg(cl + i), ml[i], i, v, p);
  }
  if (rank == 0) {
    const float* xa = x_act + lane * K;
    const float* da = d_act + lane * K;
    const int* ia = indices + lane * K;
    for (int s = tid; s < K; s += T) {
      const float t = -xa[s] / da[s];
      if (t > 0.0f && t < big) lexmin(v, p, t, ia[s]);
    }
  }

  __shared__ float sv[MAX_THREADS / 32];
  __shared__ int sp[MAX_THREADS / 32];
  __shared__ float chunk_v;  // this CTA's pair, read by rank 0
  __shared__ int chunk_p;
  const int w = tid / 32, l = tid % 32;
  warp_lexmin(v, p);
  if (l == 0) {
    sv[w] = v;
    sp[w] = p;
  }
  __syncthreads();
  if (w == 0) {
    v = l < T / 32 ? sv[l] : big;
    p = l < T / 32 ? sp[l] : 0;
    warp_lexmin(v, p);
    if (l == 0) {
      chunk_v = v;
      chunk_p = p;
    }
  }
  cluster.sync();  // every CTA's pair is written
  if (rank == 0 && tid == 0) {
    for (int r = 1; r < splits; ++r)
      lexmin(v, p, *cluster.map_shared_rank(&chunk_v, r),
             *cluster.map_shared_rank(&chunk_p, r));
    gamma[lane] = v;
    idx[lane] = p;
  }
  cluster.sync();  // no CTA leaves while rank 0 reads its shared memory
}

}  // namespace

extern "C" {

// gamma (b,) f32 and idx (b,) int32 from q, c (b,n) f32, mask (b,n) int8,
// c_inf (b,) f32, x_act, d_act (b,K) f32, indices (b,K) int32; all
// contiguous, b > 0. threads, splits (the cluster size), chunk and vec come
// from ops/cuda/scan.py::scan_launch_plan. Returns cudaGetLastError() after
// the launch (a cluster shape the card refuses never runs).
int ss_find_max_gamma(const float* q, const float* c, const int8_t* mask,
                      const float* c_inf, const float* x_act,
                      const float* d_act, const int* indices, float* gamma,
                      int* idx, int b, int n, int K, int threads, int splits,
                      int chunk, int vec, cudaStream_t stream) {
  if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * splits);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, gamma_scan_cluster_kernel, q, c,
                                       mask, c_inf, x_act, d_act, indices,
                                       gamma, idx, n, K, chunk, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
