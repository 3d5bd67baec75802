// K4: the fused OMP insert + least-squares re-solve of one greedy pick, in
// place on the lane's inverse.
//
// Replaces the Pallas TPU kernel omp_insert
// (sparse_solvers_tpu/ops/pallas/omp_insert.py:108, body _kernel :36-76;
// reference: linalg/online_inverse.py insert_unordered). Per lane, with the
// padded inverse inv = (A_ΓᵀA_Γ)⁻¹ (K x K, vacant rows and columns zero),
// the insert's Gram column u1 over the slots, vtv = ‖a_idx‖², the insert
// slot kk and the LS right-hand side b_act (A_Γᵀy, the new entry already at
// slot kk):
//   u2 = inv·u1; den = vtv − u1·u2;
//   gate = doins && |den| > 256·FLT_MIN; deg = doins && !gate;
//   gated lanes: inv += (1/den)·sv⊗sv with sv = u2 − e_kk (the bordered
//     insert as one rank-1 add, exact because vacant slots are zero);
//   every lane: coef = inv′·b_act (a lane that is not gated keeps its
//     inverse bit for bit — it is never written — and its coef is computed
//     from that unchanged inverse, as the Pallas kernel does).
// The division is IEEE (no fast-math), so a NaN den fails the guard, and
// the rank-1 update is rounded as the twin rounds it (no contraction into
// an fma).
//
// Only the live block counts. The caller keeps every vacant row and column
// (slots ≥ kk) of a lane whose result it uses at zero: the drivers start
// from zeros, zero-pad at a tier boundary and never remove a column. So a
// lane reads the kk x kk block of inv for u2 and den (an inserting lane
// reads row and column kk too, which are zero), a gated lane writes the
// (kk+1) x (kk+1) block, and coef's rows past that extent are 0. A lane
// that broke may hold a stale row kk (the drivers grow the inverse before
// they know a lane blew), but its coef is never used.
//
// What bounds it on the H100: at the drivers' capacities (24 to 128) it is
// a chain of dependent steps per lane, not a byte stream: the bytes (kk²
// read, (kk+1)² written per gated lane) bound it near 1 µs at b=256, while
// a launch with a global load, a staged block, two barriers and a store
// takes several µs whatever it moves. One block takes one lane, with a
// warp for every four rows of the capacity (ops/cuda/omp_insert.py::
// k4_launch_plan, up to 16 warps: each warp's chain of rows, a load and
// five dependent shuffles a row, is what sets the time). Each warp takes
// whole rows of the live block, its 32 threads on neighbouring column
// groups: float4 groups where K % 4 == 0 and inv is 16-byte aligned (vec
// 4), single columns otherwise (vec 1). So every access to inv is
// coalesced, and a thread only ever touches the groups of its own rows:
//   1. the warp stages its rows of the block (rows < kk, and row kk for an
//      insert) into dynamic shared memory with cp.async, and the block
//      stages u1, b_act and sv's −1 at slot kk;
//   2. u2_i = row i · u1, a warp per row, folded with shuffles; den = vtv −
//      u1·u2 from one partial sum per warp, added in the same order by
//      every thread; the gate;
//   3. a gated lane adds (di·sv_i)·sv to each of the warp's rows and
//      stores the row straight to device memory (coalesced, no write-back
//      pass); coef_i = row i of inv′ · b_act, folded with shuffles.
// Two barriers in all. The staged copy pays where inv comes from device
// memory (step 3 then reads shared memory, not L2); past the shared-memory
// cap (about K = 239) the same kernel, instantiated with kShared = false,
// reads each row from device memory in both steps and updates it in place
// there.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ops/cuda/omp_insert.py's plan states the same constants
constexpr int MAX_THREADS = 512;
constexpr int RED_FLOATS = 16;  // den's per-warp partial sums
constexpr float TINY = 256.0f * 1.1754944e-38f;  // 256·FLT_MIN, as every engine

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// V consecutive floats at p (16-byte aligned when V == 4).
template <int V>
__device__ __forceinline__ void load(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *p = x[0];
}

template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

// Shared memory: [inv's block, K rows of K, kShared only][u1][b_act][sv],
// each KV = K rounded up to 4 floats, [den's per-warp sums].
template <bool kShared, int V>
__global__ void __launch_bounds__(MAX_THREADS)
omp_insert_rows_kernel(float* __restrict__ inv, const float* __restrict__ u1,
                       const int* __restrict__ kk,
                       const float* __restrict__ vtv,
                       const float* __restrict__ b_act,
                       const uint8_t* __restrict__ doins,
                       float* __restrict__ coef, uint8_t* __restrict__ deg,
                       int K) {
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, ln = t % 32, warp = t / 32;
  const int threads = blockDim.x, warps = threads / 32;
  const size_t lane = blockIdx.x;
  const int KV = (K + 3) / 4 * 4;
  float* s_m = sm;
  float* __restrict__ s_u1 = sm + (kShared ? (size_t)K * K : 0);
  float* __restrict__ s_b = s_u1 + KV;
  float* __restrict__ s_sv = s_b + KV;  // u2 on slots < kk, −1 at slot kk
  float* __restrict__ s_red = s_sv + KV;
  float* G = inv + lane * K * K;
  const float* M = kShared ? s_m : G;
  const size_t vbase = lane * K;

  const int L = min(max(kk[lane], 0), K);  // the live block: slots < kk
  const bool ins = doins[lane] != 0;
  const float vt = vtv[lane];
  // an insert reaches row and column kk (none at capacity, kk == K)
  const int E = ins ? min(L + 1, K) : L;
  const int groups = (E + V - 1) / V;  // column groups a row of the block

  // 1. stage: the vectors (zero past their extent, to the group edge), and
  // each warp's rows
  for (int j = t; j < KV; j += threads) {
    s_u1[j] = j < L ? u1[vbase + j] : 0.0f;
    s_b[j] = j < E ? b_act[vbase + j] : 0.0f;
    s_sv[j] = ins && j == L ? -1.0f : 0.0f;
  }
  if (kShared) {
    for (int i = warp; i < E; i += warps)
      for (int g = ln; g < groups; g += 32)
        cp_async<V>(s_m + (size_t)i * K + g * V, G + (size_t)i * K + g * V);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  // 2. u2 = inv·u1 over the live block, a warp per row; lane 0 keeps
  // u1_i·u2_i for den
  float part = 0.0f;
  if (ins)
    for (int i = warp; i < L; i += warps) {
      float a = 0.0f;
      for (int g = ln; g < groups; g += 32) {
        float m[V], x[V];
        load<V>(M + (size_t)i * K + g * V, m);
        load<V>(s_u1 + g * V, x);
#pragma unroll
        for (int c = 0; c < V; ++c) a += m[c] * x[c];
      }
      a = warp_sum(a);
      if (ln == 0) {
        s_sv[i] = a;
        part += s_u1[i] * a;
      }
    }
  if (ln == 0) s_red[warp] = part;
  __syncthreads();

  // den and the gate, the same sum in the same order in every thread
  bool gate = false;
  float di = 1.0f;
  if (ins) {
    float dot = 0.0f;
    for (int w = 0; w < warps; ++w) dot += s_red[w];
    const float den = vt - dot;
    gate = fabsf(den) > TINY;
    di = 1.0f / (gate ? den : 1.0f);
  }
  if (t == 0) deg[lane] = ins && !gate;

  // 3. gated: row i of inv += (di·sv_i)·sv, stored in place; every lane:
  // coef_i = (row i of inv′)·b_act over the extent, 0 past it
  const int X = gate ? E : L;
  const int xgroups = (X + V - 1) / V;
  for (int i = warp; i < X; i += warps) {
    const float si = gate ? __fmul_rn(di, s_sv[i]) : 0.0f;
    float a = 0.0f;
    for (int g = ln; g < xgroups; g += 32) {
      float m[V], bv[V];
      load<V>(M + (size_t)i * K + g * V, m);
      load<V>(s_b + g * V, bv);
      if (gate) {
        float sv[V];
        load<V>(s_sv + g * V, sv);
#pragma unroll
        for (int c = 0; c < V; ++c) m[c] = __fadd_rn(m[c], __fmul_rn(si, sv[c]));
        store<V>(G + (size_t)i * K + g * V, m);
      }
#pragma unroll
      for (int c = 0; c < V; ++c) a += m[c] * bv[c];
    }
    a = warp_sum(a);
    if (ln == 0) coef[vbase + i] = a;
  }
  for (int i = X + t; i < K; i += threads) coef[vbase + i] = 0.0f;
}

template <bool kShared, int V>
int launch(float* inv, const float* u1, const int* kk, const float* vtv,
           const float* b_act, const uint8_t* doins, float* coef,
           uint8_t* deg, int b, int K, int threads, int smem_bytes,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      omp_insert_rows_kernel<kShared, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  omp_insert_rows_kernel<kShared, V><<<b, threads, smem_bytes, stream>>>(
      inv, u1, kk, vtv, b_act, doins, coef, deg, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One batched OMP insert + LS re-solve, in place on inv (b,K,K) f32; coef
// (b,K) f32 and deg (b,) bool out. u1, b_act (b,K) f32; kk (b,) int32;
// vtv (b,) f32; doins (b,) bool. All contiguous, b > 0, K > 0. The launch
// (threads a lane, the block staged in shared memory or not, vec 4 or 1,
// smem_bytes) comes from ops/cuda/omp_insert.py::k4_launch_plan; vec 4
// needs K % 4 == 0 and inv 16-byte aligned. Returns cudaGetLastError().
int ss_omp_insert(float* inv, const float* u1, const int* kk,
                  const float* vtv, const float* b_act, const uint8_t* doins,
                  float* coef, uint8_t* deg, int b, int K, int threads,
                  int shared, int vec, int smem_bytes, cudaStream_t stream) {
  if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      threads / 32 > RED_FLOATS || (vec != 4 && vec != 1) ||
      (vec == 4 && K % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto go = shared ? (vec == 4 ? &launch<true, 4> : &launch<true, 1>)
                         : (vec == 4 ? &launch<false, 4> : &launch<false, 1>);
  return go(inv, u1, kk, vtv, b_act, doins, coef, deg, b, K, threads,
            smem_bytes, stream);
}

}  // extern "C"
