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
// What bounds it on the H100: bytes. A gated lane reads its K x K inverse
// twice (u2, then the update fused with coef) and writes it once, about
// 3·b·K²·4 bytes per call (50 MB at b=256, K=128) against O(K²) flops per
// lane. The design keeps the inverse in device memory and only K-length
// vectors (u1, b_act, u2) in shared memory, so any capacity is served (3·K
// floats: K ≤ ~19,000 in a block's 227 KB, past the Gram route's n ≤ 16384).
// One block per lane; each warp takes whole rows, its 32 threads reading
// neighbouring columns (coalesced) and reducing with shuffles. The Pallas
// kernel's 32-lane tiles were a TPU layout and are not carried over.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float TINY = 256.0f * 1.1754944e-38f;  // 256·FLT_MIN, as every engine

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
omp_insert_kernel(float* __restrict__ inv, const float* __restrict__ u1,
                  const int* __restrict__ kk, const float* __restrict__ vtv,
                  const float* __restrict__ b_act,
                  const uint8_t* __restrict__ doins,
                  float* __restrict__ coef, uint8_t* __restrict__ deg, int K) {
  const size_t lane = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  extern __shared__ float sm[];
  float* s_u1 = sm;
  float* s_b = s_u1 + K;
  float* s_sv = s_b + K;  // u2 = inv·u1, then sv = u2 − e_kk
  __shared__ float s_red[WARPS];
  __shared__ float s_di;
  __shared__ int s_gate;

  float* M = inv + lane * K * K;
  const size_t vbase = lane * K;
  for (int s = tid; s < K; s += THREADS) {
    s_u1[s] = u1[vbase + s];
    s_b[s] = b_act[vbase + s];
  }
  __syncthreads();

  // u2 = inv·u1, a warp per row
  for (int i = warp; i < K; i += WARPS) {
    const float* row = M + (size_t)i * K;
    float a = 0.0f;
    for (int j = ln; j < K; j += 32) a += row[j] * s_u1[j];
    a = warp_sum(a);
    if (ln == 0) s_sv[i] = a;
  }
  __syncthreads();

  // den = vtv − u1·u2 and the gate
  float part = 0.0f;
  for (int j = tid; j < K; j += THREADS) part += s_u1[j] * s_sv[j];
  part = warp_sum(part);
  if (ln == 0) s_red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float dot = 0.0f;
    for (int w = 0; w < WARPS; ++w) dot += s_red[w];
    const float den = vtv[lane] - dot;
    const bool ok = fabsf(den) > TINY;
    const bool ins = doins[lane] != 0;
    s_gate = ins && ok;
    deg[lane] = ins && !ok;
    s_di = 1.0f / (ok ? den : 1.0f);
  }
  __syncthreads();
  const bool gate = s_gate;
  if (gate) {
    const int k = kk[lane];
    for (int s = tid; s < K; s += THREADS)
      s_sv[s] = s_sv[s] - (s == k ? 1.0f : 0.0f);
    __syncthreads();
  }

  // gated: row i of inv += (di·sv_i)·sv, written in place; every lane:
  // coef_i = (row i of inv′)·b_act, a warp per row
  const float di = s_di;
  for (int i = warp; i < K; i += WARPS) {
    float* row = M + (size_t)i * K;
    const float si = gate ? __fmul_rn(di, s_sv[i]) : 0.0f;
    float a = 0.0f;
    for (int j = ln; j < K; j += 32) {
      float v = row[j];
      if (gate) {
        v = __fadd_rn(v, __fmul_rn(si, s_sv[j]));
        row[j] = v;
      }
      a += v * s_b[j];
    }
    a = warp_sum(a);
    if (ln == 0) coef[vbase + i] = a;
  }
}

}  // namespace

extern "C" {

// One batched OMP insert + LS re-solve, in place on inv (b,K,K) f32; coef
// (b,K) f32 and deg (b,) bool out. u1, b_act (b,K) f32; kk (b,) int32;
// vtv (b,) f32; doins (b,) bool. All contiguous, b > 0, K > 0. Returns
// cudaGetLastError().
int ss_omp_insert(float* inv, const float* u1, const int* kk,
                  const float* vtv, const float* b_act, const uint8_t* doins,
                  float* coef, uint8_t* deg, int b, int K,
                  cudaStream_t stream) {
  const size_t bytes = 3 * (size_t)K * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      omp_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  omp_insert_kernel<<<b, THREADS, bytes, stream>>>(inv, u1, kk, vtv, b_act,
                                                   doins, coef, deg, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
