// K3: the fused active-set transition of one homotopy iteration, in place.
//
// Replaces the Pallas TPU kernel transition
// (sparse_solvers_tpu/ops/pallas/transition.py:64-295; reference:
// online_inverse.h:184-293, homotopy-cpu.cpp:252-266). Per lane, with the
// padded inverse inv = (A_ΓᵀA_Γ)⁻¹ and the active Gram gk = (AᵀA)[Γ,Γ]
// (K x K each) and the slot vectors x_act, d_act, c_act, indices:
//   den = vtv − u1ᵀ·inv·u1; an insert with |den| ≤ 256·FLT_MIN is
//     degenerate: deg is set and the lane is left untouched;
//   live lanes: x_act += γ·d_act, c_act −= γ·gk·d_act;
//   insert at slot kk: inv += (1/den)·(u2 − e_kk)(u2 − e_kk)ᵀ with
//     u2 = inv·u1, gk gains row/column kk = (u1, vtv), c_act[kk] += c′,
//     indices[kk] = idx;
//   remove at slot p (indices[p] == idx): the Schur downdate
//     inv −= inv[:,p]·inv[p,:]/inv[p,p], then the last live slot l = kk−1
//     moves into p in inv, gk, x_act, c_act and indices, and slot l is
//     cleared (zero rows and columns, index = sentinel);
//   live lanes: d_act = inv′·sign_deadzone(c_act′, tol).
// The caller's contract: doins and dorm imply live, and dorm implies that
// idx is one of the lane's indices.
//
// What bounds it on the H100: per lane it reads and writes the two K x K
// matrices (72 KiB at K=96, 19 MB for b=256) plus a few K-vectors, and does
// O(K²) flops — a memory-bound pass of a few µs at HBM rate, dominated in
// practice by the serial K-long dot products of the matvecs. One block per
// lane holds inv and gk in dynamic shared memory (row stride K|1, odd, so
// the row-per-thread matvecs hit distinct banks), above 48 KB after
// cudaFuncSetAttribute; about K = 167 fills the 227 KB a block can have.
// Beyond that the same kernel, instantiated with kShared = false, runs the
// same per-lane math on inv and gk where they lie in device memory,
// updated in place, with its K-vectors in a (b, 9K) device workspace that
// the wrapper allocates — so no capacity is refused; every element update
// reads and writes only its own element, so working in place is exact.
// The branches are per lane, as the TPU kernel's tile-level pl.when could
// not be: an inert lane returns at once and touches nothing, only a
// removing lane runs the downdate, and only an inserting or removing lane
// writes its matrices. Frozen state is kept by not writing it — never by
// a 0·x multiply.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr float TINY = 256.0f * 1.1754944e-38f;  // 256·FLT_MIN, as every engine

__host__ __device__ inline int row_stride(int K) { return K | 1; }

__host__ __device__ inline size_t smem_bytes(int K) {
  // inv, gk (K x row_stride) + 8 float K-vectors + the int indices
  return (2 * (size_t)K * row_stride(K) + 9 * (size_t)K) * sizeof(float);
}

// kShared: inv and gk are staged in shared memory and written back;
// otherwise they are worked on in place in device memory and the nine
// K-vectors live in work (b, 9K).
template <bool kShared>
__global__ void __launch_bounds__(THREADS)
transition_kernel(float* __restrict__ inv, float* __restrict__ gk,
                  float* __restrict__ x_act, float* __restrict__ d_act,
                  float* __restrict__ c_act, int* __restrict__ indices,
                  const float* __restrict__ u1, const int* __restrict__ idx,
                  const int* __restrict__ kk, const float* __restrict__ gamma,
                  const float* __restrict__ vtv, const float* __restrict__ cnew,
                  const uint8_t* __restrict__ live,
                  const uint8_t* __restrict__ doins,
                  const uint8_t* __restrict__ dorm, uint8_t* __restrict__ deg,
                  float* __restrict__ work, float tol, int sentinel, int K) {
  const size_t lane = blockIdx.x;
  const int tid = threadIdx.x;
  if (!live[lane]) {  // inert lane: state untouched
    if (tid == 0) deg[lane] = 0;
    return;
  }

  extern __shared__ float sm[];
  const size_t mbase = lane * K * K, vbase = lane * K;
  const int L = kShared ? row_stride(K) : K;
  float* s_inv = kShared ? sm : inv + mbase;
  float* s_gk = kShared ? s_inv + K * L : gk + mbase;
  float* s_x = kShared ? s_gk + K * L : work + lane * 9 * K;
  float* s_d = s_x + K;
  float* s_ca = s_d + K;
  float* s_u1 = s_ca + K;
  float* s_u2 = s_u1 + K;
  float* s_gd = s_u2 + K;
  float* s_w1 = s_gd + K;
  float* s_w2 = s_w1 + K;
  int* s_ind = reinterpret_cast<int*>(s_w2 + K);
  __shared__ float s_di;
  __shared__ int s_ok, s_ins, s_rm, s_p;

  if (kShared) {
    for (int e = tid; e < K * K; e += THREADS) {
      const int i = e / K, j = e % K;
      s_inv[i * L + j] = inv[mbase + e];
      s_gk[i * L + j] = gk[mbase + e];
    }
  }
  for (int s = tid; s < K; s += THREADS) {
    s_x[s] = x_act[vbase + s];
    s_d[s] = d_act[vbase + s];
    s_ca[s] = c_act[vbase + s];
    s_u1[s] = u1[vbase + s];
    s_ind[s] = indices[vbase + s];
  }
  __syncthreads();

  // u2 = inv·u1 (the insert's border) and gd = gk·d (the c_act step)
  for (int i = tid; i < K; i += THREADS) {
    float a = 0.0f, g = 0.0f;
    for (int j = 0; j < K; ++j) {
      a += s_inv[i * L + j] * s_u1[j];
      g += s_gk[i * L + j] * s_d[j];
    }
    s_u2[i] = a;
    s_gd[i] = g;
  }
  __syncthreads();

  if (tid == 0) {
    float dot = 0.0f;
    for (int j = 0; j < K; ++j) dot += s_u1[j] * s_u2[j];
    const float den = vtv[lane] - dot;
    const bool okins = fabsf(den) > TINY;
    const bool bad = doins[lane] && !okins;
    deg[lane] = bad;
    s_ok = !bad;
    s_ins = doins[lane] && okins;
    s_rm = dorm[lane];
    s_di = 1.0f / (okins ? den : 1.0f);
    s_p = -1;
  }
  __syncthreads();
  if (!s_ok) return;  // degenerate insert: lane left untouched
  const bool ins = s_ins, rm = s_rm;

  const float g = gamma[lane];
  for (int s = tid; s < K; s += THREADS) {
    s_x[s] = s_x[s] + g * s_d[s];
    s_ca[s] = s_ca[s] - g * s_gd[s];
  }

  if (ins) {
    const int k = kk[lane];
    const float di = s_di;
    for (int s = tid; s < K; s += THREADS)
      s_w1[s] = s_u2[s] - (s == k ? 1.0f : 0.0f);
    __syncthreads();
    for (int e = tid; e < K * K; e += THREADS) {
      const int i = e / K, j = e % K;
      s_inv[i * L + j] = s_inv[i * L + j] + (di * s_w1[i]) * s_w1[j];
    }
    for (int j = tid; j < K; j += THREADS) {
      if (j == k) {
        s_gk[k * L + k] = (s_gk[k * L + k] + s_u1[k]) + (s_u1[k] + vtv[lane]);
        s_ca[k] = s_ca[k] + cnew[lane];
        s_ind[k] = s_ind[k] + (idx[lane] - sentinel);
      } else {
        s_gk[k * L + j] = s_gk[k * L + j] + s_u1[j];
        s_gk[j * L + k] = s_gk[j * L + k] + s_u1[j];
      }
    }
  }

  if (rm) {
    const int l = kk[lane] - 1;
    const int target = idx[lane];
    for (int s = tid; s < K; s += THREADS)
      if (s_ind[s] == target) s_p = s;
    __syncthreads();
    const int p = s_p;
    if (p >= 0) {
      const float dpp = s_inv[p * L + p];
      for (int i = tid; i < K; i += THREADS) {
        s_w1[i] = s_inv[i * L + p];  // column p of inv
        s_u2[i] = s_gk[i * L + l];   // column l of gk
      }
      __syncthreads();
      for (int i = tid; i < K; i += THREADS)  // column l of the downdate
        s_w2[i] = s_inv[i * L + l] - (s_w1[i] / dpp) * s_w1[l];
      __syncthreads();
      for (int e = tid; e < K * K; e += THREADS) {
        const int i = e / K, j = e % K;
        float vi, vg;
        if (i == l || j == l) {
          vi = 0.0f;
          vg = 0.0f;
        } else if (i == p && j == p) {
          vi = s_w2[l];
          vg = s_u2[l];
        } else if (i == p) {
          vi = s_w2[j];
          vg = s_u2[j];
        } else if (j == p) {
          vi = s_w2[i];
          vg = s_u2[i];
        } else {
          vi = s_inv[i * L + j] - (s_w1[i] / dpp) * s_w1[j];
          vg = s_gk[i * L + j];
        }
        s_inv[i * L + j] = vi;
        s_gk[i * L + j] = vg;
      }
      if (tid == 0) {
        if (p != l) {
          s_x[p] = s_x[l];
          s_ca[p] = s_ca[l];
          s_ind[p] = s_ind[l];
        }
        s_x[l] = 0.0f;
        s_ca[l] = 0.0f;
        s_ind[l] = sentinel;
      }
    }
  }
  __syncthreads();

  // direction from the post-toggle state: d = inv′·sign_deadzone(c_act′)
  for (int s = tid; s < K; s += THREADS) {
    const float v = s_ca[s];
    s_w1[s] = v > tol ? 1.0f : (v < -tol ? -1.0f : 0.0f);
  }
  __syncthreads();
  for (int i = tid; i < K; i += THREADS) {
    float a = 0.0f;
    for (int j = 0; j < K; ++j) a += s_inv[i * L + j] * s_w1[j];
    d_act[vbase + i] = a;
    x_act[vbase + i] = s_x[i];
    c_act[vbase + i] = s_ca[i];
    indices[vbase + i] = s_ind[i];
  }
  if (kShared && (ins || rm)) {
    for (int e = tid; e < K * K; e += THREADS) {
      const int i = e / K, j = e % K;
      inv[mbase + e] = s_inv[i * L + j];
      gk[mbase + e] = s_gk[i * L + j];
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs to hold inv and gk at capacity K;
// the wrapper passes a workspace instead where this exceeds the card's cap.
int ss_transition_smem_bytes(int K) { return static_cast<int>(smem_bytes(K)); }

// One batched transition, in place on inv, gk (b,K,K), x_act, d_act, c_act
// (b,K) f32 and indices (b,K) int32; deg (b,) bool out. u1 (b,K) f32;
// idx, kk (b,) int32; gamma, vtv, cnew (b,) f32; live, doins, dorm (b,)
// bool. All contiguous, b > 0. work is null (inv and gk staged in shared
// memory) or a (b, 9K) f32 scratch (inv and gk worked on in device
// memory). Returns cudaGetLastError().
int ss_transition(float* inv, float* gk, float* x_act, float* d_act,
                  float* c_act, int* indices, const float* u1, const int* idx,
                  const int* kk, const float* gamma, const float* vtv,
                  const float* cnew, const uint8_t* live, const uint8_t* doins,
                  const uint8_t* dorm, uint8_t* deg, float* work, float tol,
                  int sentinel, int b, int K, cudaStream_t stream) {
  if (work == nullptr) {
    const size_t bytes = smem_bytes(K);
    cudaError_t err = cudaFuncSetAttribute(
        transition_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    transition_kernel<true><<<b, THREADS, bytes, stream>>>(
        inv, gk, x_act, d_act, c_act, indices, u1, idx, kk, gamma, vtv, cnew,
        live, doins, dorm, deg, nullptr, tol, sentinel, K);
  } else {
    transition_kernel<false><<<b, THREADS, 0, stream>>>(
        inv, gk, x_act, d_act, c_act, indices, u1, idx, kk, gamma, vtv, cnew,
        live, doins, dorm, deg, work, tol, sentinel, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
