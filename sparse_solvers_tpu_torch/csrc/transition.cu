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
// The caller's contract: doins and dorm imply live, doins implies
// kk < K, dorm implies that idx is one of the lane's indices, and every
// vacant slot (≥ kk) has zero rows and columns in inv and gk, u1 = 0,
// x_act = d_act = c_act = 0 and index = sentinel (the drivers' init,
// remove's move and the ladder's embed keep it; so does this kernel).
//
// What bounds it on the H100: per lane it needs the live kk x kk blocks of
// inv and gk once, inv's new block written once and gk's changed border,
// about 9.6 MB at K=96, b=256 on chip_smoke.py's mix: under 3 µs at HBM
// rate. The time is latency, a chain of dependent steps per lane (load,
// reduce, decide, update, reduce): the design before this one ran the dot
// u1ᵀu2 on thread 0 alone and each matvec one thread a row. So one block
// takes a lane, touches only its live block (slots below kk; slot kk too
// on an insert), and keeps the chain short, with two routes by capacity
// (ops/cuda/transition.py::k3_launch_plan):
//   registers (K ≤ 128; 256 threads, at most 128 registers a thread up to
//     K = 96, so two blocks share a multiprocessor and b=256 runs in one
//     wave): each thread holds a fixed tile of inv, rows w + 8r (r < 4C)
//     by columns lane + 32c (c < C = ⌈K/32⌉, at most REG_FLOATS floats:
//     36 at K=96), read once with coalesced loads, updated in registers
//     and written once. Every load of the lane is issued before the first
//     barrier, branch-free, so they are in flight together;
//   device (K > 128; 512 threads): inv is worked on in place in device
//     memory, a warp on 8 rows at a time, its lanes on neighbouring
//     columns; its second pass over the block is served by L2. (Staging
//     inv's block in shared memory with cp.async instead, to K = 236, ran
//     no faster on the card: 2 % ahead at K = 200, 11 % and 3 % behind at
//     129 and 236.)
// On every route:
//   1. the per-lane scalars in one round of loads; the K-vectors staged in
//      shared memory (past K ≈ 5800, where even they do not fit, in a
//      per-lane device workspace), with column l of gk on a remove and
//      each warp's candidate for the slot p;
//   2. gd = gk·d streamed from gk's live block (warps over rows, lanes
//      over columns, float4 loads where K % 4 == 0 and the bases are
//      aligned; a column of a row's last group past the live extent is
//      selected away) and, on an insert, u2 = inv·u1; a thread's row sums
//      folded across the warp together; c_act −= γ·gd; den's per-warp
//      partial sums meet in one shared-memory step, summed in the same
//      order by every thread;
//   3. the guard: a degenerate insert returns having written only deg;
//   4. a removing lane stages columns p and l of inv; the slot vectors
//      (the step, the insert's slot kk, remove's move) are written, and
//      the signs of c_act′ staged;
//   5. each entry of inv's new block follows from its old value and the
//      staged vectors alone (element-local: no value moves between
//      threads; selects, no branches, one form for an insert and one for
//      a remove), is written once, and feeds d = inv′·sign(c_act′) in the
//      same pass;
//   6. gk is written only where it changes: row and column kk on an
//      insert, rows and columns p and l on a remove.
// Inert lanes return at once and touch nothing; a lane that neither
// inserts nor removes writes no matrix. Frozen state is kept by not
// writing it, never by a 0·x multiply. The updates are rounded as the
// twin rounds them (__fmul_rn/__fadd_rn: no contraction into an fma).
// Measured on an H100 (chip_smoke.py's K3 phases, b=256): about 0.01 ms
// of device time at K=96, over three times what its bytes need at HBM
// rate; the chain of dependent steps, not the bytes, still sets it.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// ops/cuda/transition.py's plan states the same constants
constexpr int THREADS = 256;      // a block, registers route (8 warps)
constexpr int MEM_THREADS = 512;  // a block, device routes
constexpr int REG_FLOATS = 64;    // inv's floats a thread holds, registers route
constexpr int VECTORS = 10;       // K-vectors staged per lane
constexpr int RED_FLOATS = 32;    // den's per-warp sums, then p's, 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_WARPS = RED_FLOATS / 2;
constexpr float TINY = 256.0f * 1.1754944e-38f;  // 256·FLT_MIN, as every engine
static_assert(MEM_THREADS / 32 <= MAX_WARPS, "a warp's slots in red");

enum Route { kRegisters = 0, kDevice = 1, kDeviceWork = 2 };

__host__ __device__ inline int padded(int K) { return (K + 3) / 4 * 4; }
__host__ __device__ inline size_t vector_floats(int K) {
  return (size_t)VECTORS * padded(K) + RED_FLOATS;
}
size_t smem_needed(int K, int route) {
  if (route == kDeviceWork) return 0;
  return 4 * vector_floats(K);
}

struct Args {
  float* inv;
  float* gk;
  float* x_act;
  float* d_act;
  float* c_act;
  int* indices;
  const float* u1;
  const int* idx;
  const int* kk;
  const float* gamma;
  const float* vtv;
  const float* cnew;
  const uint8_t* live;
  const uint8_t* doins;
  const uint8_t* dorm;
  uint8_t* deg;
  float* work;
  float tol;
  int sentinel;
  int K;
};

// One lane's context: its live extent L (= kk), the extent E it writes
// (L + 1 on an insert), the remove's slots p and l, its prefetched
// scalars and its staged vectors.
struct Lane {
  size_t mb, vb;  // offsets of the lane's K x K blocks and K-vectors
  int L, E, p, l, idx;
  bool ins, rm;
  float g, vtv, cnew, di, dpp, rll;
  float *u1, *d, *x, *ca, *u2, *sgn, *colp, *coll, *gkl, *red;
  int* ind;
};

// N sums folded across the warp together: N independent shuffles a step.
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(0xffffffffu, v[n], o);
}

// Columns j0 … j0+V−1 of a row, where ok: one 16-byte load for V = 4
// (K % 4 == 0, so the group lies inside the row; a column past the live
// extent L is selected away, its value never used), else zeros. No
// branch, so the loads of many rows are in flight together.
template <int V>
__device__ __forceinline__ void load_group(const float* row, int j0, int L,
                                           bool ok, float (&f)[V]) {
  if constexpr (V == 4) {
    const float4 v = ok ? *reinterpret_cast<const float4*>(row + j0)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    f[0] = j0 < L ? v.x : 0.0f;
    f[1] = j0 + 1 < L ? v.y : 0.0f;
    f[2] = j0 + 2 < L ? v.z : 0.0f;
    f[3] = j0 + 3 < L ? v.w : 0.0f;
  } else {
    f[0] = ok && j0 < L ? row[j0] : 0.0f;
  }
}

// Step 1: every per-lane scalar in one round of loads; an inert lane
// returns false having written deg = 0, any other gets its context.
__device__ bool begin(const Args& a, float* vbase, Lane& s) {
  const size_t lane = blockIdx.x;
  const int K = a.K;
  const bool live = a.live[lane] != 0;
  const int kk = a.kk[lane];
  s.ins = a.doins[lane] != 0;
  s.rm = a.dorm[lane] != 0;
  s.g = a.gamma[lane];
  s.vtv = a.vtv[lane];
  s.cnew = a.cnew[lane];
  s.idx = a.idx[lane];
  if (!live) {
    if (threadIdx.x == 0) a.deg[lane] = 0;
    return false;
  }
  s.mb = lane * K * K;
  s.vb = lane * K;
  s.L = min(max(kk, 0), K);
  s.rm = s.rm && s.L > 0;
  s.E = s.ins ? min(s.L + 1, K) : s.L;
  s.l = s.L - 1;
  s.p = -1;
  s.di = s.dpp = s.rll = 1.0f;
  const int KV = padded(K);
  s.u1 = vbase;
  s.d = s.u1 + KV;
  s.x = s.d + KV;
  s.ca = s.x + KV;
  s.u2 = s.ca + KV;
  s.sgn = s.u2 + KV;
  s.colp = s.sgn + KV;
  s.coll = s.colp + KV;
  s.gkl = s.coll + KV;
  s.ind = reinterpret_cast<int*>(s.gkl + KV);
  s.red = vbase + (size_t)VECTORS * KV;
  return true;
}

// One slot's staged values: u1 (an insert's), d, x, the index, c_act at
// the insert's slot kk (the live slots' c_act come from their rows'
// owners in step 2) and, on a remove, gk[k, l] (column l of gk).
struct Slot {
  float u1, d, x, ca, gkl;
  int ind;
};

__device__ __forceinline__ Slot load_slot(const Args& a, const Lane& s,
                                          int k) {
  Slot v;
  v.u1 = s.ins ? a.u1[s.vb + k] : 0.0f;
  v.d = a.d_act[s.vb + k];
  v.x = a.x_act[s.vb + k];
  v.ind = a.indices[s.vb + k];
  v.ca = k >= s.L ? a.c_act[s.vb + k] : 0.0f;
  v.gkl = s.rm ? a.gk[s.mb + (size_t)k * a.K + s.l] : 0.0f;
  return v;
}

__device__ __forceinline__ void store_slot(const Lane& s, int k,
                                           const Slot& v) {
  s.u1[k] = v.u1;
  s.d[k] = v.d;
  s.x[k] = v.x;
  s.ind[k] = v.ind;
  if (k >= s.L) s.ca[k] = v.ca;
  if (s.rm) s.gkl[k] = v.gkl;
}

// A removing lane's slot p is the first slot holding idx: each warp leaves
// the least of its threads' candidates in red[MAX_WARPS + w] (INT_MAX:
// none).
__device__ __forceinline__ void p_candidates(const Lane& s, int cand) {
  cand = __reduce_min_sync(0xffffffffu, cand);
  if (threadIdx.x % 32 == 0)
    reinterpret_cast<int*>(s.red)[MAX_WARPS + threadIdx.x / 32] = cand;
}

// Step 1 on the memory routes: every slot below E staged (a loop: E may
// pass the block's threads), and the candidates for p.
__device__ void stage_all(const Args& a, const Lane& s) {
  int cand = INT_MAX;
  for (int k = threadIdx.x; k < s.E; k += blockDim.x) {
    const Slot v = load_slot(a, s, k);
    store_slot(s, k, v);
    if (s.rm && k < s.L && v.ind == s.idx) cand = min(cand, k);
  }
  p_candidates(s, cand);
}

// Step 3, after a barrier: den from the per-warp sums in a fixed order;
// false for a degenerate insert (deg written, nothing else).
__device__ __forceinline__ bool decide(const Args& a, Lane& s) {
  const size_t lane = blockIdx.x;
  float dot = 0.0f;
  int p = INT_MAX;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) {
    dot += s.red[w];
    p = min(p, reinterpret_cast<const int*>(s.red)[MAX_WARPS + w]);
  }
  const float den = s.vtv - dot;
  const bool ok = fabsf(den) > TINY;
  const bool bad = s.ins && !ok;
  if (threadIdx.x == 0) a.deg[lane] = bad;
  if (bad) return false;
  s.di = __fdiv_rn(1.0f, ok ? den : 1.0f);
  if (s.rm) {
    s.rm = p != INT_MAX;  // the caller's contract says idx is present
    s.p = s.rm ? p : -1;
  }
  return true;
}

// Step 4: the slot vectors out (x and c_act stepped, the insert's slot
// kk, remove's move of l into p and clearing of l) and sign(c_act′)
// staged for the direction.
__device__ void vectors_out(const Args& a, const Lane& s) {
  const float tol = a.tol;
  for (int k = threadIdx.x; k < s.E; k += blockDim.x) {
    float x, ca;
    int id;
    if (s.rm && k == s.l) {
      x = 0.0f;
      ca = 0.0f;
      id = a.sentinel;
    } else {
      const int src = s.rm && k == s.p ? s.l : k;
      x = __fadd_rn(s.x[src], __fmul_rn(s.g, s.d[src]));
      ca = s.ca[src];
      id = s.ind[src];
      if (s.ins && k == s.L) {
        ca = __fadd_rn(ca, s.cnew);
        id = id + (s.idx - a.sentinel);
      }
    }
    s.sgn[k] = ca > tol ? 1.0f : (ca < -tol ? -1.0f : 0.0f);
    a.x_act[s.vb + k] = x;
    a.c_act[s.vb + k] = ca;
    a.indices[s.vb + k] = id;
  }
}

// Step 6: gk written only where it changes.
__device__ void gk_border(const Args& a, const Lane& s) {
  const int K = a.K;
  float* G = a.gk + s.mb;
  if (s.ins) {
    const int L = s.L;
    for (int k = threadIdx.x; k < s.E; k += blockDim.x) {
      if (k < L) {
        G[(size_t)L * K + k] = s.u1[k];
        G[(size_t)k * K + L] = s.u1[k];
      } else {
        G[(size_t)L * K + L] = s.vtv;
      }
    }
  }
  if (s.rm) {
    const int p = s.p, l = s.l;
    for (int k = threadIdx.x; k < s.L; k += blockDim.x) {
      G[(size_t)l * K + k] = 0.0f;
      G[(size_t)k * K + l] = 0.0f;
      if (p != l && k != l) {
        if (k == p) {
          G[(size_t)p * K + p] = s.gkl[l];
        } else {
          G[(size_t)p * K + k] = s.gkl[k];
          G[(size_t)k * K + p] = s.gkl[k];
        }
      }
    }
  }
}

// Column l of the downdate at row x: inv[x,l] − (inv[x,p]/inv[p,p])·inv[l,p].
__device__ __forceinline__ float down_l(const Lane& s, int x) {
  return __fsub_rn(s.coll[x],
                   __fmul_rn(__fdiv_rn(s.colp[x], s.dpp), s.colp[s.l]));
}

// Step 5's ingredients, after the columns and signs are staged. A column
// j's: its sign, the insert's border sv_j = u2_j − [j = kk], and on a
// remove inv[j,p] and column l of the downdate at j. A row i's: its
// factor (di·sv_i on an insert, inv[i,p]/inv[p,p] on a remove) and
// column l of the downdate at i.
struct Col {
  float sg, sv, cp, rl;
};
struct Row {
  float q, rl;
};

__device__ __forceinline__ float sv(const Lane& s, int j) {
  return j < s.L ? s.u2[j] : (j == s.L ? -1.0f : 0.0f);
}

__device__ __forceinline__ Col col_of(const Lane& s, int j) {
  Col c{0.0f, 0.0f, 0.0f, 0.0f};
  if (j < s.E) c.sg = s.sgn[j];
  if (s.ins) c.sv = sv(s, j);
  if (s.rm && j < s.L) {
    c.cp = s.colp[j];
    c.rl = down_l(s, j);
  }
  return c;
}

__device__ __forceinline__ Row row_of(const Lane& s, int i) {
  Row r{0.0f, 0.0f};
  if (s.ins) r.q = __fmul_rn(s.di, sv(s, i));
  if (s.rm && i < s.L) {
    r.q = __fdiv_rn(s.colp[i], s.dpp);
    r.rl = down_l(s, i);
  }
  return r;
}

// The remove's pivot and the moved diagonal, once the columns are staged.
__device__ __forceinline__ void pivot(Lane& s) {
  if (!s.rm) return;
  s.dpp = s.colp[s.p];
  s.rll = down_l(s, s.l);
}

// Step 5's element rule for a lane that inserts (kInsert) or removes:
// entry (i, j) of inv′ from its old value v, exactly as the twin rounds
// it, with selects in place of branches.
template <bool kInsert>
__device__ __forceinline__ float new_entry(const Lane& s, int i, int j,
                                           float v, const Row& r,
                                           const Col& c) {
  if constexpr (kInsert) return __fadd_rn(v, __fmul_rn(r.q, c.sv));
  float e = __fsub_rn(v, __fmul_rn(r.q, c.cp));
  e = j == s.p ? r.rl : e;
  e = i == s.p ? (j == s.p ? s.rll : c.rl) : e;
  return i == s.l || j == s.l ? 0.0f : e;
}

// kRule: 0 no toggle (inv′ = inv, nothing written), 1 insert, 2 remove.
enum Rule { kKeep = 0, kInsertRule = 1, kRemoveRule = 2 };

// Step 5 on the registers route: thread (w, lane) holds entries (w +
// WARPS·r, lane + 32c) of inv's block in m.
template <int kRule, int R, int C>
__device__ __forceinline__ void regs_step5(const Args& a, const Lane& s,
                                           const float (&m)[R][C]) {
  const int ln = threadIdx.x % 32, w = threadIdx.x / 32;
  Col col[C];
#pragma unroll
  for (int c = 0; c < C; ++c) col[c] = col_of(s, ln + 32 * c);
  float* out = a.inv + s.mb;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = w + WARPS * r;
    const Row row = kRule == kKeep ? Row{0.0f, 0.0f} : row_of(s, i);
    acc[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = ln + 32 * c;
      const bool in = i < s.E && j < s.E;
      float v = m[r][c];
      if constexpr (kRule != kKeep) {
        v = new_entry<kRule == kInsertRule>(s, i, j, v, row, col[c]);
        if (in) out[(size_t)i * a.K + j] = v;
      }
      acc[r] += in ? v * col[c].sg : 0.0f;
    }
  }
  warp_sums(acc);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = w + WARPS * r;
    if (ln == 0 && i < s.E) a.d_act[s.vb + i] = acc[r];
  }
}

// Registers route: rows w + WARPS·r (r < R = 4C) by columns lane + 32c
// (c < C) of inv's live block in each thread; V columns a gk load. Row
// w + WARPS·r lies in column chunk r / 4 at lane w + WARPS·(r % 4), so a
// row's u1 and c_act come from the column layout by one shuffle. Step 2
// runs before the first barrier: every load of the lane (its slot, inv's
// block, gk's block, d, u1 and c_act) is issued in one round, and the R
// row sums of a thread are folded across the warp together.
template <int C, int V>
__global__ void __launch_bounds__(THREADS, C <= 3 ? 2 : 1)
transition_regs_kernel(Args a) {
  constexpr int R = 32 * C / WARPS;
  constexpr int G = V == 4 ? (C + 3) / 4 : C;  // gk column groups a lane takes
  static_assert(R == 4 * C, "row r of a thread lies in column chunk r / 4");
  extern __shared__ __align__(16) float sm[];
  Lane s;
  if (!begin(a, sm, s)) return;
  const int K = a.K, t = threadIdx.x, ln = t % 32, w = t / 32;
  const float* inv = a.inv + s.mb;
  const float* gk = a.gk + s.mb;

  // 1-2. the loads: this thread's slot (E ≤ K ≤ THREADS here), inv's
  // block, d over gk's column groups, u1 and c_act over the columns
  Slot slot{};
  if (t < s.E) slot = load_slot(a, s, t);
  float m[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = w + WARPS * r;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = ln + 32 * c;
      m[r][c] = i < s.L && j < s.L ? inv[(size_t)i * K + j] : 0.0f;
    }
  }
  float dv[G * V];
#pragma unroll
  for (int q = 0; q < G * V; ++q) {
    const int j = (ln + 32 * (q / V)) * V + q % V;
    dv[q] = j < s.L ? a.d_act[s.vb + j] : 0.0f;
  }
  float u1v[C], cav[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = ln + 32 * c;
    u1v[c] = s.ins && j < s.L ? a.u1[s.vb + j] : 0.0f;
    cav[c] = j < s.L ? a.c_act[s.vb + j] : 0.0f;
  }
  const int groups = (s.L + V - 1) / V;
  float gv[R][G][V];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = w + WARPS * r;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int g = ln + 32 * q;
      load_group<V>(gk + (size_t)i * K, g * V, s.L, i < s.L && g < groups,
                    gv[r][q]);
    }
  }
  float gd[R], u2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    gd[r] = u2[r] = 0.0f;
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int c = 0; c < V; ++c) gd[r] += gv[r][q][c] * dv[q * V + c];
#pragma unroll
    for (int c = 0; c < C; ++c) u2[r] += m[r][c] * u1v[c];
  }
  if (t < s.E) store_slot(s, t, slot);
  p_candidates(s, s.rm && t < s.L && slot.ind == s.idx ? t : INT_MAX);

  // 2. gd = gk·d, u2 = inv·u1 (insert), the rows folded across the warp
  // together; each row's c_act stepped
  warp_sums(gd);
  if (s.ins) warp_sums(u2);
  float part = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = w + WARPS * r, owner = w + WARPS * (r % 4);
    const float cai = __shfl_sync(0xffffffffu, cav[r / 4], owner);
    const float u1i = __shfl_sync(0xffffffffu, u1v[r / 4], owner);
    if (ln == 0 && i < s.L) {
      s.ca[i] = __fsub_rn(cai, __fmul_rn(s.g, gd[r]));
      s.u2[i] = u2[r];
      part += u1i * u2[r];
    }
  }
  if (ln == 0) s.red[w] = part;
  __syncthreads();

  // 3. the guard
  if (!decide(a, s)) return;

  // 4. columns p and l of inv (a remove), the slot vectors, the signs
  if (s.rm) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = w + WARPS * r;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = ln + 32 * c;
        if (i < s.L && j == s.p) s.colp[i] = m[r][c];
        if (i < s.L && j == s.l) s.coll[i] = m[r][c];
      }
    }
  }
  vectors_out(a, s);
  __syncthreads();
  gk_border(a, s);

  // 5. inv′ element by element, written once; d = inv′·sign(c_act′)
  pivot(s);
  if (s.ins)
    regs_step5<kInsertRule, R, C>(a, s, m);
  else if (s.rm)
    regs_step5<kRemoveRule, R, C>(a, s, m);
  else
    regs_step5<kKeep, R, C>(a, s, m);
}

// Step 5 on the device routes: a warp takes RB rows at a time, its lanes
// neighbouring columns, in place in inv.
template <int kRule, int RB, int NW>
__device__ __forceinline__ void mem_step5(const Args& a, const Lane& s,
                                          float* inv) {
  const int K = a.K, ln = threadIdx.x % 32, w = threadIdx.x / 32;
  for (int i0 = w; i0 < s.E; i0 += RB * NW) {
    Row row[RB];
    float acc[RB];
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int i = i0 + q * NW;
      row[q] = kRule == kKeep ? Row{0.0f, 0.0f} : row_of(s, i);
      acc[q] = 0.0f;
    }
    for (int j = ln; j < s.E; j += 32) {
      const Col col = col_of(s, j);
      float v[RB];
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int i = i0 + q * NW;
        v[q] = i < s.L && j < s.L ? inv[(size_t)i * K + j] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int i = i0 + q * NW;
        if constexpr (kRule != kKeep) {
          v[q] = new_entry<kRule == kInsertRule>(s, i, j, v[q], row[q], col);
          if (i < s.E) inv[(size_t)i * K + j] = v[q];
        }
        acc[q] += i < s.E ? v[q] * col.sg : 0.0f;
      }
    }
    warp_sums(acc);
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int i = i0 + q * NW;
      if (ln == 0 && i < s.E) a.d_act[s.vb + i] = acc[q];
    }
  }
}

// Device routes: inv in place in device memory; the vectors in shared
// memory (kDevice) or in the per-lane workspace (kDeviceWork).
// MEM_THREADS threads; a warp works on RB rows together, so that RB loads
// are in flight at a time and the RB row sums fold across the warp
// together.
template <int kWhere, int V>
__global__ void __launch_bounds__(MEM_THREADS)
transition_mem_kernel(Args a) {
  constexpr int RB = 8, NW = MEM_THREADS / 32;
  extern __shared__ __align__(16) float sm[];
  const int K = a.K, t = threadIdx.x, ln = t % 32, w = t / 32;
  float* vbase =
      kWhere == kDeviceWork ? a.work + blockIdx.x * vector_floats(K) : sm;
  Lane s;
  if (!begin(a, vbase, s)) return;
  stage_all(a, s);
  float* inv = a.inv + s.mb;
  const float* gk = a.gk + s.mb;
  const int groups = (s.L + V - 1) / V;
  __syncthreads();

  // 2. gd = gk·d; u2 = inv·u1 (insert); the rows' c_act stepped
  float part = 0.0f;
  for (int i0 = w; i0 < s.L; i0 += RB * NW) {
    float gd[RB], u2[RB], car[RB];
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int i = i0 + q * NW;
      gd[q] = u2[q] = 0.0f;
      car[q] = i < s.L ? a.c_act[s.vb + i] : 0.0f;
    }
    for (int g = ln; g < groups; g += 32) {
      float f[RB][V];
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int i = i0 + q * NW;
        load_group<V>(gk + (size_t)i * K, g * V, s.L, i < s.L, f[q]);
      }
      float dj[V];  // d over the group; slots past L are not staged
#pragma unroll
      for (int c = 0; c < V; ++c) dj[c] = g * V + c < s.L ? s.d[g * V + c] : 0.0f;
#pragma unroll
      for (int q = 0; q < RB; ++q)
#pragma unroll
        for (int c = 0; c < V; ++c) gd[q] += f[q][c] * dj[c];
    }
    if (s.ins)
      for (int j = ln; j < s.L; j += 32) {
        const float u1j = s.u1[j];
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          const int i = i0 + q * NW;
          if (i < s.L) u2[q] += inv[(size_t)i * K + j] * u1j;
        }
      }
    warp_sums(gd);
    if (s.ins) warp_sums(u2);
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const int i = i0 + q * NW;
      if (ln == 0 && i < s.L) {
        s.ca[i] = __fsub_rn(car[q], __fmul_rn(s.g, gd[q]));
        s.u2[i] = u2[q];
        part += s.u1[i] * u2[q];
      }
    }
  }
  if (ln == 0) s.red[w] = part;
  __syncthreads();

  // 3. the guard
  if (!decide(a, s)) return;

  // 4. columns p and l of inv (a remove), the slot vectors, the signs
  if (s.rm)
    for (int k = t; k < s.L; k += MEM_THREADS) {
      s.colp[k] = inv[(size_t)k * K + s.p];
      s.coll[k] = inv[(size_t)k * K + s.l];
    }
  vectors_out(a, s);
  __syncthreads();
  gk_border(a, s);

  // 5. inv′ element by element, in place (each entry is read and
  // written by one thread, every load of a step before its stores),
  // d = inv′·sign(c_act′)
  pivot(s);
  if (s.ins)
    mem_step5<kInsertRule, RB, NW>(a, s, inv);
  else if (s.rm)
    mem_step5<kRemoveRule, RB, NW>(a, s, inv);
  else
    mem_step5<kKeep, RB, NW>(a, s, inv);
}

using Kernel = void (*)(Args);

template <int C>
Kernel regs(int vec) {
  return vec == 4 ? transition_regs_kernel<C, 4> : transition_regs_kernel<C, 1>;
}

template <int kWhere>
Kernel mem(int vec) {
  return vec == 4 ? transition_mem_kernel<kWhere, 4>
                  : transition_mem_kernel<kWhere, 1>;
}

Kernel pick(int route, int cols, int vec) {
  switch (route) {
    case kRegisters:
      switch (cols) {
        case 1: return regs<1>(vec);
        case 2: return regs<2>(vec);
        case 3: return regs<3>(vec);
        case 4: return regs<4>(vec);
        default: return nullptr;
      }
    case kDevice: return mem<kDevice>(vec);
    case kDeviceWork: return mem<kDeviceWork>(vec);
    default: return nullptr;
  }
}

static_assert(4 * 4 * 4 <= REG_FLOATS, "the widest register tile");

}  // namespace

extern "C" {

// One batched transition, in place on inv, gk (b,K,K), x_act, d_act, c_act
// (b,K) f32 and indices (b,K) int32; deg (b,) bool out. u1 (b,K) f32;
// idx, kk (b,) int32; gamma, vtv, cnew (b,) f32; live, doins, dorm (b,)
// bool. All contiguous, b > 0, K > 0. The launch comes from
// ops/cuda/transition.py::k3_launch_plan: route 0 registers (THREADS
// threads, cols = C, 32·C ≥ K, 4·C² ≤ REG_FLOATS), 1 device, 2 device
// with the vectors in work, a (b, VECTORS·⌈K/4⌉·4 + RED_FLOATS)
// f32 workspace (null otherwise), each MEM_THREADS threads; vec 4 (float4
// rows: K % 4 == 0, inv and gk 16-byte aligned) or 1; smem_bytes at
// least what the route stages. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a launch it does not take.
int ss_transition(float* inv, float* gk, float* x_act, float* d_act,
                  float* c_act, int* indices, const float* u1, const int* idx,
                  const int* kk, const float* gamma, const float* vtv,
                  const float* cnew, const uint8_t* live, const uint8_t* doins,
                  const uint8_t* dorm, uint8_t* deg, float* work, float tol,
                  int sentinel, int b, int K, int route, int threads, int cols,
                  int vec, int smem_bytes, cudaStream_t stream) {
  const bool bad_regs =
      route == kRegisters &&
      (cols < 1 || 32 * cols < K || 4 * cols * cols > REG_FLOATS);
  if (b <= 0 || K <= 0 || (vec != 4 && vec != 1) || (vec == 4 && K % 4) ||
      bad_regs || threads != (route == kRegisters ? THREADS : MEM_THREADS) ||
      smem_bytes < 0 ||
      static_cast<size_t>(smem_bytes) < smem_needed(K, route) ||
      (route == kDeviceWork) != (work != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kern = pick(route, cols, vec);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{inv,   gk,    x_act, d_act, c_act, indices, u1,
               idx,   kk,    gamma, vtv,   cnew,  live,    doins,
               dorm,  deg,   work,  tol,   sentinel, K};
  kern<<<b, threads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
