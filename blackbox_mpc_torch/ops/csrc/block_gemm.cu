// The block-diagonal linear layer of the RSSM's core on Hopper's tensor cores (sm_90a):
// out[g] = x[g] @ w[g] + b[g] for every group g, in float32 accuracy.
//
// Replaces no kernel of the JAX package: its RSSM runs none, and the port computed the layer
// with torch.baddbmm (models/rssm.py::block_linear), which cuBLAS runs as a float32 SIMT gemm
// at about 47 TFLOP/s, 70 % of the card's 67 TFLOP/s float32 FMA peak. DreamerV3's size200m
// core has two such layers, 8 groups of [rows x 4096] @ [4096 x 1024] and of [rows x 1024] @
// [1024 x 3072]; at the planner's 1000 rows they hold 64 % of an act()'s FLOPs.
//
// The tensor cores take float32 only as TF32 (10 mantissa bits). The product is kept float32-
// accurate by splitting each operand into hi + lo, two TF32 values rounded to nearest, ties
// away (cvt.rna.tf32.f32), and summing three products, hi(x).hi(w) + hi(x).lo(w) + lo(x).hi(w);
// only lo.lo (about 2^-22 of a term) is left out, as in mlp_step.cuh's dense_tf32. The
// weights come split already (ops/block_gemm.py::block_pack): [groups, out, in], K-major as
// TF32 wgmma requires, hi and lo apart. x ([groups, rows, in], K-major already) is split in
// registers here, so it is read once and needs no pass of its own.
//
// What bounds it: three TF32 products put the float32 ceiling at a third of the TF32 rate,
// 165 TFLOP/s of the card's 495. A CTA computes a 128 x 128 output tile of one group: two
// warpgroups of 64 rows each run wgmma.m64n128k8 with A (x's fragments) from registers and
// B (the weights) from shared memory, over a ring of kStages stages that TMA fills (x's
// 128 x 32 tile, w's hi and lo 128 x 32 tiles, 48 KB a stage, 128-byte swizzled). Thread 0
// starts the loads: it refills a stage as soon as both warpgroups have released it. The
// weights stream from HBM once a call (0.47 GB at size200m): the CTAs that share a weight tile
// (the row tiles of one group's column tile) are adjacent in the grid, blockIdx.x fastest, so
// they run together and read it from L2 (about 5 TB/s at 110 TFLOP/s). With its loads cut the
// kernel ran only 118-124 TFLOP/s on an H100 (PERF.md): the stage loop binds, not L2. Each
// warpgroup waits for its stage's 12 wgmma before it adds hi.hi into the sum and loads the next
// fragments, and the registers leave no room to overlap them.
//
// Registers set the shape. A thread holds three 64-float sets (below) and the 32 fragment
// registers of a stage's four k8 steps: 239 registers, which only a CTA of 256 threads
// allows. A producer warp or warpgroup beside the two (288 or 384 threads) caps ptxas at 168
// registers a thread whatever setmaxnreg asks, and the spills held those layouts to 32-47
// TFLOP/s on an H100, against 96-108 for this one (PERF.md).
//
// The accumulator truncates: a long chain of mma into one accumulator drifts (a 75-mma
// chain of mlp_step.cuh's dense_tf32 by 40x). hi.hi therefore goes to its own accumulator,
// restarted every stage (scale-d 0, four mma) and added into a float32 register sum with a
// rounded add; the two correction products share a second accumulator over the whole K, where
// their truncation (2^-11 of the sum) is lost. No split-K and no atomics: a shape gives the
// same bits on every launch, eager or graphed.
//
// The wrapper refuses what the kernel does not tile: in a multiple of kTileK, out a multiple
// of kTileN. Rows are free: TMA fills the rows past the end with zeros and the epilogue stores
// only real rows.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 128;  // rows of x a CTA: two warpgroups of 64
constexpr int kTileN = 128;  // output columns a CTA: one wgmma n
constexpr int kTileK = 32;   // K a stage: 32 float32, one 128-byte swizzle row
constexpr int kSteps = kTileK / 8;  // wgmma k8 steps a stage
constexpr int kStages = 4;
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kWarps = 4 * kWarpgroups;
constexpr uint32_t kABytes = kTileM * kTileK * 4;
constexpr uint32_t kBBytes = kTileN * kTileK * 4;
constexpr uint32_t kStageBytes = kABytes + 2 * kBBytes;
// The stages (1024-byte aligned for the swizzle), then a full and an empty barrier a stage.
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the barrier's phase of the given parity has completed. A wait of some 10 s
// (2^34 cycles) can only be a fault of the pipeline: it traps, so the launch fails with an
// error where it would hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// A [kTileK, box rows, 1] box of a [groups, rows, K] tensor at (k, row, group).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k, int row, int group) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row), "r"(group)
      : "memory");
}

// A K-major B operand in shared memory, 128-byte swizzled: rows of 128 bytes, 8-row groups
// 1024 bytes apart (the stride byte offset); the leading byte offset is unused.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// Keeps the compiler from moving a register's reads or writes across the point: wgmma reads
// and writes its registers asynchronously, between the instruction and wgmma.wait_group.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= a @ b: a the 64 x 8 TF32 fragment of the warpgroup's rows, b 8 x 128 from shared
// memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

struct Pipe {
  uint32_t base;  // the stages, 1024-byte aligned
  uint32_t bars;  // full[kStages], then empty[kStages]
  __device__ __forceinline__ uint32_t stage(int s) const { return base + s * kStageBytes; }
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (kStages + s); }
};

struct Maps {
  const CUtensorMap* x;
  const CUtensorMap* hi;
  const CUtensorMap* lo;
};

// Loads k tile kt into its stage: x's 128 x 32 box, w's hi and lo 128 x 32 boxes.
__device__ __forceinline__ void load_stage(const Pipe& p, const Maps& maps, int kt, int m0,
                                            int n0, int group) {
  const int s = kt % kStages;
  const uint32_t a = p.stage(s);
  mbar_expect_tx(p.full(s), kStageBytes);
  tma_load(a, maps.x, p.full(s), kt * kTileK, m0, group);
  tma_load(a + kABytes, maps.hi, p.full(s), kt * kTileK, n0, group);
  tma_load(a + kABytes + kBBytes, maps.lo, p.full(s), kt * kTileK, n0, group);
}

// One CTA: the output tile (blockIdx.x: 128 rows, blockIdx.y: 128 columns) of group
// blockIdx.z. x_map reads x [groups, rows, k]; hi_map and lo_map the split weights
// [groups, n, k]; bias [groups, n]; out [groups, rows, n]. Warpgroup wg (0, 1) owns rows
// 64 wg .. 64 wg + 63 of the tile; thread 0 also refills each stage as soon as both
// warpgroups have released it.
__global__ void __launch_bounds__(kThreads, 1)
    block_gemm_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap hi_map,
                      const __grid_constant__ CUtensorMap lo_map, const float* __restrict__ bias,
                      float* __restrict__ out, int rows, int k, int n) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  Pipe p;
  p.base = (raw + 1023) & ~1023u;
  p.bars = p.base + kStages * kStageBytes;
  const uint8_t* stages = smem_raw + (p.base - raw);
  const Maps maps{&x_map, &hi_map, &lo_map};
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN, group = blockIdx.z;
  const int k_tiles = k / kTileK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(p.full(s), 1);
      mbar_init(p.empty(s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kt = 0; kt < kStages && kt < k_tiles; ++kt) load_stage(p, maps, kt, m0, n0, group);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // This thread's rows of the tile: r and r + 8 (r % 8 == g, the swizzle's row phase).
  const int r = 64 * wg + 16 * (threadIdx.x / 32 % 4) + g;
  // A warpgroup whose 64 rows all lie past the end computes nothing (rows 1 on the filter).
  const bool active = m0 + 64 * wg < rows;

  float sum[64], hh[64], corr[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = hh[i] = corr[i] = 0.0f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(p.full(s), (kt / kStages) & 1);
    if (active) {
      const float* a_tile = reinterpret_cast<const float*>(stages + s * kStageBytes);
      const uint32_t hi_tile = p.stage(s) + kABytes, lo_tile = hi_tile + kBBytes;
      // x's fragments of the stage's four k8 steps: element (row, 4c + t) of the 128-byte
      // swizzled tile lies in 16-byte chunk c ^ (row % 8) of its row.
      uint32_t ah[kSteps][4], al[kSteps][4];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int c = 2 * j;
        split_tf32(a_tile[r * 32 + ((c ^ g) << 2) + t], ah[j][0], al[j][0]);
        split_tf32(a_tile[(r + 8) * 32 + ((c ^ g) << 2) + t], ah[j][1], al[j][1]);
        split_tf32(a_tile[r * 32 + (((c + 1) ^ g) << 2) + t], ah[j][2], al[j][2]);
        split_tf32(a_tile[(r + 8) * 32 + (((c + 1) ^ g) << 2) + t], ah[j][3], al[j][3]);
      }
      fence_regs(hh);
      fence_regs(corr);
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        fence_regs(ah[j]);
        fence_regs(al[j]);
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const uint32_t kb = 32 * j;  // the k8 step's 32 bytes in each B row
        wgmma_tf32(hh, ah[j], b_desc(hi_tile + kb), j);  // j == 0: hh starts afresh
        wgmma_tf32(corr, ah[j], b_desc(lo_tile + kb), 1);
        wgmma_tf32(corr, al[j], b_desc(hi_tile + kb), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(hh);
      fence_regs(corr);
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        fence_regs(ah[j]);
        fence_regs(al[j]);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], hh[i]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(p.empty(s));
    if (threadIdx.x == 0 && kt + kStages < k_tiles) {  // refill the stage once both released it
      mbar_wait(p.empty(s), (kt / kStages) & 1);
      load_stage(p, maps, kt + kStages, m0, n0, group);
    }
  }

  if (!active) return;
  // Accumulator layout of m64n128: register 4j + 2h + e holds row r + 8h, column 8j + 2t + e.
  const float* b = bias + static_cast<size_t>(group) * n + n0;
  float* o = out + (static_cast<size_t>(group) * rows + m0) * n + n0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 bj = *reinterpret_cast<const float2*>(b + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (m0 + row < rows) {
        const int i = 4 * j + 2 * h;
        float2 v;
        v.x = __fadd_rn(__fadd_rn(sum[i], corr[i]), bj.x);
        v.y = __fadd_rn(__fadd_rn(sum[i + 1], corr[i + 1]), bj.y);
        *reinterpret_cast<float2*>(o + static_cast<size_t>(row) * n + col) = v;
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime, so the library links
// against nothing beyond the runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Returned where the tensor maps cannot be made (no entry point in libcuda, a refused map).
constexpr int kMapFailed = 10000;

// A map of the float32 tensor [groups, outer, k] read in [1, box_rows, kTileK] boxes.
bool make_map(CUtensorMap* map, const void* ptr, int groups, int outer, int k, int box_rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(groups)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(k) * 4,
                                 static_cast<cuuint64_t>(k) * outer * 4};
  const cuuint32_t box[3] = {kTileK, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Sets the kernel's shared memory; call once before any launch or capture.
int bbmpc_block_gemm_prepare() {
  cudaFuncSetAttribute(block_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  return static_cast<int>(cudaGetLastError());
}

// out [groups, rows, n] = x [groups, rows, k] @ w + bias, w given as its split halves
// w_hi, w_lo [groups, n, k] (float32 holding TF32 values), bias [groups, n]; all float32,
// contiguous, 16-byte aligned. k a multiple of 32, n of 128. Launches on `stream`.
int bbmpc_block_gemm(const void* x, const void* w_hi, const void* w_lo, const void* bias,
                     void* out, int groups, int rows, int k, int n, void* stream) {
  if (groups < 1 || rows < 1 || k < kTileK || k % kTileK || n < kTileN || n % kTileN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap x_map, hi_map, lo_map;
  if (!make_map(&x_map, x, groups, rows, k, kTileM) ||
      !make_map(&hi_map, w_hi, groups, n, k, kTileN) ||
      !make_map(&lo_map, w_lo, groups, n, k, kTileN)) {
    return kMapFailed;
  }
  const dim3 grid((rows + kTileM - 1) / kTileM, n / kTileN, groups);
  block_gemm_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x_map, hi_map, lo_map, static_cast<const float*>(bias), static_cast<float*>(out), rows,
      k, n);
  return static_cast<int>(cudaGetLastError());
}

// What a launch occupies: shared memory a CTA, CTAs a multiprocessor, registers a thread,
// local (spilled) bytes, threads a CTA.
int bbmpc_block_gemm_attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, block_gemm_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, block_gemm_kernel, kThreads,
                                                      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kSmemBytes;
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = kThreads;
  return 0;
}

}  // extern "C"
