// K1's tile GEMM on Hopper: TMA feeds wgmma in a warp-specialised block.
//
// C (M,N) = L (M,K) · B (K,N), bf16 operands, fp32 sums, C f32 or bf16
// (rounded to nearest even). L is row-major (K-major). B comes from a
// row-major matrix R that is stored (N,K) (B_MN false: B = Rᵀ, K-major, how
// K1's first pass reads A16) or (K,N) (B_MN true: B = R, N-major, how its
// second pass reads A16): wgmma reads the second form through its
// transposed-B operand, so neither pass copies A16.
//
// It replaces, for every K1 shape TMA can describe, the cp.async ring
// (tile_gemm.cuh's ring::gemm_bf16_async_kernel, which stays for K5, K6 and
// K1's fallback). That ring stages 128x64 tiles with cp.async and multiplies
// with mma.sync; its copies alone took 0.2042 ms of 0.2512 at b=256, m=4096,
// n=8192 (tools/probe_k1_ring.py): the L2 traffic of small tiles, each A16
// tile staged once per 128-lane batch tile. Here:
//
//   * a block is three warpgroups: a producer (one thread issues the TMA
//     loads; setmaxnreg gives its registers away) and two consumers, each
//     issuing wgmma.mma_async m64nBNk16 on 64-row slabs of the batch tile;
//   * the batch tile is BM = 128·SLABS lanes (256 at K1's b = 256), so each
//     A16 tile leaves L2 or HBM once a pass, not once per 128 lanes;
//   * a ring of STAGES 64-deep slices, each an L tile of BM rows and an R
//     tile of BN, 128-byte swizzled by TMA as wgmma reads them, with a
//     full and an empty mbarrier per stage: TMA completes the full one,
//     the consumers' warps arrive on the empty one once their products of
//     the slice have retired (wgmma.wait_group 1, so one slice's products
//     overlap the next one's issue);
//   * the depth may be split (blockIdx.z takes [z·k_chunk, min(K, (z+1)·
//     k_chunk)) and writes C + z·M·ldc) where the output is too narrow to
//     fill the card; gemm_bf16_async_kernel_split_sum adds the ranges in
//     the fixed order z = 0..S-1, so repeat runs stay bit-identical.
//
// TMA zero-fills reads past the edges and the epilogue masks its stores, so
// any M, N, K run; TMA needs 16-byte-aligned bases and row strides, so K1
// takes this route only where m and n are multiples of 8 and A16 starts on
// 16 bytes (ops/cuda/kernels.py::k1_launch_plan). The tensor maps are
// encoded on the host for each launch (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint, so the library needs no -lcuda) and passed by
// value as __grid_constant__ parameters, which a captured CUDA graph keeps.
//
// Kernel names are the benchmark's attribution contract: perfbench/metrics
// find K1's launches by the substrings "round_to_bf16_kernel" and
// "gemm_bf16_async_kernel", so both kernels here carry the second.
//
// Everything here has internal linkage, as in tile_gemm.cuh.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "tile_gemm.cuh"

namespace tile_gemm {
namespace {
namespace wg {

// The geometry (ops/cuda/kernels.py::k1_launch_plan states the same
// numbers; tests/test_torch_k1_plan.py reads them here). Batch tiles BM of
// 128 or 256 lanes (SLABS 1 or 2 slabs of 64 a consumer), column tiles BN
// of 64 or 128: the pairs `launch` instantiates.
constexpr int BK = 64;              // depth of one slice: a 128-byte row
constexpr int STAGES = 4;           // slices in the ring
constexpr int CONSUMERS = 2;        // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40;   // setmaxnreg: 128·40 + 256·232 ≤ 65536
constexpr int CONSUMER_REGS = 232;
constexpr int BOX_BYTES = 64 * 128;  // a 64-row box of 128-byte rows

template <int SLABS, int BN>
struct Tile {
  static constexpr int BM = 64 * CONSUMERS * SLABS;
  static constexpr int L_BYTES = BM * BK * 2;
  static constexpr int R_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = L_BYTES + R_BYTES;
  // the ring, and 1024 bytes to align it as the 128-byte swizzle needs
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
  static_assert(SMEM_BYTES <= 232448, "past a block's shared memory");
  static_assert(L_BYTES % 1024 == 0 && R_BYTES % 1024 == 0,
                "every tile starts on a swizzle atom");
  static_assert(BN % 64 == 0 && BN <= 128,
                "N-major R comes in 64-column boxes");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Spin until the phase of the given parity has completed (a fresh barrier
// counts the phase before its first as completed: parity 1 passes).
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// A box of the map at coordinates (c0 along the rows, c1 across them) into
// shared memory; its bytes count against the barrier's expected
// transaction count as they land.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous products (which would make ptxas serialise them).
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x N f32, the warpgroup's fragment) += A (64x16, K-major) · B (16xN,
// K-major, or N-major with TRANS_B), both read from shared memory through
// their descriptors. Fragment: thread t of the warpgroup holds, for each
// 8-column block j, rows 16(t/32) + (t%32)/4 and that + 8, columns 8j +
// 2(t%4) and that + 1, in d[4j .. 4j+3] (row, row, row + 8, row + 8).
template <int N, int TRANS_B>
struct Wgmma;

template <int TRANS_B>
struct Wgmma<64, TRANS_B> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TRANS_B));
  }
};

template <int TRANS_B>
struct Wgmma<128, TRANS_B> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1), "n"(TRANS_B));
  }
};

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The consumer's fragments into C (row-major, leading dimension ldc),
// masked at the edges. N is even on this route, so a pair is in or out.
template <typename TC, int SLABS, int BN>
__device__ __forceinline__ void store_tile(TC* C,
                                           const float (&acc)[SLABS][BN / 2],
                                           int row0, int n0, int M, int N,
                                           int ldc) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int sl = 0; sl < SLABS; ++sl) {
    const int r = row0 + sl * 64 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      if (c >= N) continue;
      if (r < M)
        store2(C + (size_t)r * ldc + c, acc[sl][4 * j], acc[sl][4 * j + 1]);
      if (r + 8 < M)
        store2(C + (size_t)(r + 8) * ldc + c, acc[sl][4 * j + 2],
               acc[sl][4 * j + 3]);
    }
  }
}

// C = L·B over split blockIdx.z's depth range into C + z·M·ldc (C bf16
// when c_bf16, else f32). tl maps L with boxes of BM rows x BK; tr maps R
// with boxes of BN rows x BK (B_MN false) or BK rows x 64 columns (B_MN
// true, BN/64 boxes a slice). Launch with THREADS threads and
// Tile::SMEM_BYTES of dynamic shared memory, grid (ceil(M/BM), ceil(N/BN),
// S), no range empty: the batch tiles run along blockIdx.x, so blocks that
// share an R tile are adjacent.
template <int SLABS, int BN, bool B_MN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16_async_kernel(const __grid_constant__ CUtensorMap tl,
                       const __grid_constant__ CUtensorMap tr, void* C,
                       int M, int N, int K, int ldc, int k_chunk,
                       bool c_bf16) {
  using G = Tile<SLABS, BN>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];  // full, then empty
  const uint32_t ring = (smem_u32(wg_smem) + 1023) & ~1023u;
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * STAGES;

  const int kbeg = blockIdx.z * k_chunk;
  const int nk = (min(K, kbeg + k_chunk) - kbeg + BK - 1) / BK;
  const int m0 = blockIdx.x * G::BM, n0 = blockIdx.y * BN;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);  // a warp of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&tl)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&tr)) : "memory");
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(full, G::STAGE_BYTES);
        const int k0 = kbeg + kt * BK;
        const uint32_t ls = ring + s * G::STAGE_BYTES, rs = ls + G::L_BYTES;
        tma_load(ls, &tl, k0, m0, full);
        if (B_MN) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(rs + j * BOX_BYTES, &tr, n0 + 64 * j, k0, full);
        } else {
          tma_load(rs, &tr, k0, n0, full);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    const int cw = wgi - 1;
    float acc[SLABS][BN / 2];
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[sl][i] = 0.0f;

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full0 + 8 * s, (kt / STAGES) & 1);
      const uint32_t ls = ring + s * G::STAGE_BYTES, rs = ls + G::L_BYTES;
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl) fence_operand(acc[sl]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // K-major tiles: 128-byte rows, 8-row atoms 1024 bytes apart, the
        // 16-deep step 32 bytes into the row; the N-major R: 64-column
        // boxes BOX_BYTES apart, 8-row atoms 1024 apart, the step 16 rows
        const uint64_t db = B_MN
            ? desc_sw128(rs + kk * 16 * 128, BOX_BYTES, 1024)
            : desc_sw128(rs + kk * 32, 16, 1024);
#pragma unroll
        for (int sl = 0; sl < SLABS; ++sl) {
          const uint64_t da = desc_sw128(
              ls + (cw * SLABS + sl) * 64 * 128 + kk * 32, 16, 1024);
          Wgmma<BN, B_MN ? 1 : 0>::mma(acc[sl], da, db);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the slice before this one is done with: hand its stage back
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl) fence_operand(acc[sl]);
      if (kt > 0 && threadIdx.x % 32 == 0)
        mbar_arrive(empty0 + 8 * ((kt - 1) % STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) fence_operand(acc[sl]);

    const int row0 = m0 + cw * SLABS * 64 + 16 * ((threadIdx.x / 32) % 4);
    const size_t split = (size_t)blockIdx.z * M * ldc;
    if (c_bf16)
      store_tile<bf16, SLABS, BN>(static_cast<bf16*>(C) + split, acc, row0,
                                  n0, M, N, ldc);
    else
      store_tile<float, SLABS, BN>(static_cast<float*>(C) + split, acc, row0,
                                   n0, M, N, ldc);
  }
}

// out[i] = bf16(Σ_z part[z][i]) for z = 0..S-1 in that order: the split
// pass's ranges summed, then rounded as the unsplit epilogue rounds its
// sums. part is (S, count) f32; count a multiple of 4, part 16-byte and
// out 8-byte aligned (the route's m % 8 == 0 and the wrapper's buffers).
__global__ void gemm_bf16_async_kernel_split_sum(const float* __restrict__ part,
                                                 int S, size_t count,
                                                 bf16* __restrict__ out) {
  const float4* p4 = reinterpret_cast<const float4*>(part);
  const size_t n4 = count / 4;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 s = p4[i];
    for (int z = 1; z < S; ++z) {
      const float4 v = p4[(size_t)z * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    store4(out + 4 * i, reinterpret_cast<const float*>(&s));
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The CUDA driver API's cuTensorMapEncodeTiled, looked up once through the
// runtime.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of the row-major (rows, cols) bf16 matrix at `base` (16-byte
// aligned, cols a multiple of 8) in boxes of box_rows rows x 64 columns,
// 128-byte swizzled, zeros past the edges.
inline cudaError_t encode(CUtensorMap* map, const bf16* base, int rows,
                          int cols, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<bf16*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int SLABS, int BN, bool B_MN>
cudaError_t launch_pass(const CUtensorMap& tl, const CUtensorMap& tr, void* C,
                        bool c_bf16, int M, int N, int K, int ldc, int splits,
                        int k_chunk, cudaStream_t stream) {
  using G = Tile<SLABS, BN>;
  static std::atomic<unsigned long long> ready{0};  // a bit per device
  cudaError_t err = allow_smem(gemm_bf16_async_kernel<SLABS, BN, B_MN>,
                               G::SMEM_BYTES, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + G::BM - 1) / G::BM, (N + BN - 1) / BN, splits);
  gemm_bf16_async_kernel<SLABS, BN, B_MN>
      <<<grid, THREADS, G::SMEM_BYTES, stream>>>(tl, tr, C, M, N, K, ldc,
                                                 k_chunk, c_bf16);
  return cudaGetLastError();
}

// C = L·B with the plan's batch tile bm and column tile bn: the maps are
// encoded by the caller with those boxes (L: bm rows; R: bn rows, or 64
// with B_MN). Any other pair is refused.
template <bool B_MN>
cudaError_t launch(int bm, int bn, const CUtensorMap& tl,
                   const CUtensorMap& tr, void* C, bool c_bf16, int M, int N,
                   int K, int ldc, int splits, int k_chunk,
                   cudaStream_t stream) {
  if (bm == 128 && bn == 64)
    return launch_pass<1, 64, B_MN>(tl, tr, C, c_bf16, M, N, K, ldc, splits,
                                    k_chunk, stream);
  if (bm == 128 && bn == 128)
    return launch_pass<1, 128, B_MN>(tl, tr, C, c_bf16, M, N, K, ldc, splits,
                                     k_chunk, stream);
  if (bm == 256 && bn == 64)
    return launch_pass<2, 64, B_MN>(tl, tr, C, c_bf16, M, N, K, ldc, splits,
                                    k_chunk, stream);
  if (bm == 256 && bn == 128)
    return launch_pass<2, 128, B_MN>(tl, tr, C, c_bf16, M, N, K, ldc, splits,
                                     k_chunk, stream);
  return cudaErrorInvalidValue;
}

cudaError_t split_sum(const float* part, int S, size_t count, bf16* out,
                      cudaStream_t stream) {
  gemm_bf16_async_kernel_split_sum<<<stride_blocks(count, 4), 256, 0,
                                     stream>>>(part, S, count, out);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace
}  // namespace tile_gemm
