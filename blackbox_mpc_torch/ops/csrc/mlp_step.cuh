// One horizon step of the ensemble-MLP dynamics for a tile of rows, shared by the rollout
// kernel (rollout.cu, K2) and the fused CEM kernels (fused_cem.cu, K4/K5). It is K1 of the JAX
// package: ops/_kernel_common.py::build_step_fn, without the reward.
//
// Per step: normalize (eps 1e-7) -> E-member MLP (tanh/relu/gelu, float32 accumulation,
// float32 bias, activation then cast to the compute type) -> member mean, or the tile's one
// member for ts1 -> denormalize -> delta.
//
// The design, for Hopper. The members of an ensemble are independent inside a step, so with
// mean propagation a thread-block cluster of C = min(E, 8) CTAs owns one tile of T rows and
// CTA `rank` runs the members rank, rank + C, ... (one member at E = 5) through every layer for
// those rows. A CTA so fetches one member's weights per step and feeds every weight element to
// T rows. Each CTA leaves its members' head outputs [out_w][T] in its own shared memory; after
// one cluster.sync() every CTA reads all E of them from its peers (distributed shared memory),
// adds them in member order 0..E-1 (so the sum does not depend on scheduling), divides,
// denormalizes and forms the next state locally. The head buffer is double-buffered by the
// step's parity, which is why one cluster barrier per step is enough. ts1 runs the tile's one
// member in a cluster of one.
//
// float32 (dense): SIMT FMAs. A thread owns a block of output columns x RB rows in registers
// over the whole K, so the wide layers need no partial sums: on a tile of 32 rows or more 8
// columns x T/4 rows on 256 threads of up to 255 registers (96 accumulators at T = 48; two
// 16-byte weight loads and T/16 16-byte loads of activations feed 8 * T/4 FMAs), on a smaller
// tile 4 columns on 512 threads. Activations lie [feature][row]; a warp's lanes take the row
// blocks fastest, so its weight loads are whole 128-byte lines and its activation loads four
// addresses. Only a layer with fewer such blocks than half the threads (the 17-wide head;
// every layer of a tile below 16 rows) splits K across threads and adds the partials in a
// second pass, in slice order. The weights come through plain register loads, 8 k's unrolled:
// rings of weight slabs in shared memory (cp.async with a barrier per slab, and cp.async.bulk
// on mbarriers; the tile leaves 24 KB for them) and an explicit register double buffer all
// measured slower on the H100 (PERF.md).
//
// bfloat16 (dense_mma): tensor cores, mma.sync.m16n8k16 with float32 accumulation. With few
// rows the weights take the 16-row m side, out^T[N, T] = W^T[N, K] . X^T[K, T], and the rows
// the 8-wide n side, so no m row is padding. The wrapper packs each [K, N] block in fragment
// order (16x16 tiles, a lane's four registers contiguous), so one 16-byte load per lane is a
// whole A fragment, straight from L2 into registers. Activations lie [row][feature] in bf16
// (rounded after the activation, as the plain version rounds), the row stride padded by 8
// elements so that the B-fragment loads hit 32 different banks. The head stays in float32.
//
// What bounds the loop on the H100 is in rollout.cu's note.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

// Rows per tile, one per propagation; ops/rollout_kernel.py holds the same two numbers
// (TILE_MEAN, TILE_TS1) with the measurement behind them, and every entry point checks the
// tile it is given against them. The macros exist for that measurement's sweep only.
#ifndef BBMPC_TILE_MEAN
#define BBMPC_TILE_MEAN 48
#endif
#ifndef BBMPC_TILE_TS1
#define BBMPC_TILE_TS1 8
#endif

constexpr int kTileMean = BBMPC_TILE_MEAN;
constexpr int kTileTs1 = BBMPC_TILE_TS1;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxLayers = 8;
constexpr float kEps = 1e-7f;

__host__ __device__ constexpr int round_up16(int n) { return (n + 15) / 16 * 16; }

template <typename W>
constexpr bool kIsBf16 = false;
template <>
constexpr bool kIsBf16<__nv_bfloat16> = true;

// How a tile of T rows in compute type W is laid on a CTA.
template <int T, typename W>
struct Cfg {
  // A float32 tile of 32 rows or more gives each thread 8 columns x T/4 rows, so that a layer
  // of 500 columns fills 256 threads of up to 255 registers; else 4 columns on 512 threads.
  static constexpr bool kWide = !kIsBf16<W> && T >= 32;
  static constexpr int kThreads = kWide ? 256 : 512;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kColVecs = kWide ? 2 : 1;      // float4 weight vectors per thread and k
  static constexpr int kRows = T >= 16 ? T / 4 : T;   // rows of a thread's register block
  // CTAs per SM that the design counts on, declared in each kernel's __launch_bounds__: a
  // tile of 32 rows or more fills an SM's shared memory alone.
  static constexpr int kMinBlocks = T >= 32 ? 1 : 2;
};

struct NetShape {
  int n_layers;
  int width[kMaxLayers + 1];    // padded widths (multiples of 4): input, hidden..., output
  long long w_off[kMaxLayers];  // element offset of layer l's E weight blocks
  long long w_size[kMaxLayers]; // elements of one member's block of layer l
  long long b_off[kMaxLayers];  // element offset of layer l's [E, N] bias block
  int ks[kMaxLayers];           // float32: K slices of layer l (1: no partial sums)
  int max_hidden;               // widest padded hidden layer (>= 4)
  int red_width;                // float32: partial-sum scratch of the hidden layers, ks * N
};

struct Problem {
  int horizon, rows, dim_s, dim_u, stats_width, ensemble;
  int activation, normalized, predict_delta;
};

// The members a CTA runs and the ones a tile sums: `count` members from `base`; this CTA takes
// the local indices rank, rank + stride, ... and keeps index i in head slot i / stride.
struct Members {
  int base, count, rank, stride;
};

__device__ __forceinline__ Members tile_members(int member, int ensemble, int rank,
                                                int cluster) {
  if (member < 0) return Members{0, ensemble, rank, cluster};
  return Members{member, 1, 0, 1};
}

__host__ __device__ __forceinline__ int head_slots(int ensemble, int cluster) {
  return (ensemble + cluster - 1) / cluster;
}

__device__ __forceinline__ void load4(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

__device__ __forceinline__ float activate(float x, int act) {
  if (act == 0) return tanhf(x);
  if (act == 1) return x < 0.f ? 0.f : x;
  // jax.nn.gelu's default tanh approximation.
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return x * (0.5f * (1.f + tanhf(c * (x + 0.044715f * (x * x * x)))));
}

// N contiguous floats at p, aligned to V floats.
template <int N, int V>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[N]) {
  if constexpr (V == 4) {
#pragma unroll
    for (int r = 0; r < N; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + r);
      x[r] = v.x; x[r + 1] = v.y; x[r + 2] = v.z; x[r + 3] = v.w;
    }
  } else if constexpr (V == 2) {
#pragma unroll
    for (int r = 0; r < N; r += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + r);
      x[r] = v.x; x[r + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int r = 0; r < N; ++r) x[r] = p[r];
  }
}

template <int N, int V>
__device__ __forceinline__ void store_rows(float* p, const float (&x)[N]) {
  if constexpr (V == 4) {
#pragma unroll
    for (int r = 0; r < N; r += 4)
      *reinterpret_cast<float4*>(p + r) = make_float4(x[r], x[r + 1], x[r + 2], x[r + 3]);
  } else if constexpr (V == 2) {
#pragma unroll
    for (int r = 0; r < N; r += 2) *reinterpret_cast<float2*>(p + r) = make_float2(x[r], x[r + 1]);
  } else {
#pragma unroll
    for (int r = 0; r < N; ++r) p[r] = x[r];
  }
}

// K slices of a float32 layer of padded width n on a tile of T rows.
template <int T>
int k_slices(int k, int n) {
  using C = Cfg<T, float>;
  const int blocks = ((n / 4 + C::kColVecs - 1) / C::kColVecs) * (T / C::kRows);
  int ks = C::kThreads / blocks;
  if (ks < 1) ks = 1;
  if (ks > k) ks = k;
  return ks;
}

// float32: out[n*T + r] = f(sum_k in[k*T + r] * w[k*N + n] + b[n]) for n < N, r < T, f the
// activation, or the identity for the head (`last`). A thread owns CV float4 column vectors x
// RB rows over one K slice; `red` holds ks_count * N * T partials where ks_count > 1.
template <int T>
__device__ void dense(const float* in, int K, int N, int ks_count, const float* __restrict__ w,
                      const float* __restrict__ b, float* red, float* out, bool last, int act) {
  using C = Cfg<T, float>;
  constexpr int RB = C::kRows, CV = C::kColVecs, kThreads = C::kThreads;
  constexpr int RBN = T / RB;
  constexpr int V = RB % 4 == 0 ? 4 : (RB % 2 == 0 ? 2 : 1);
  // Weight loads in flight per thread. Measured on the H100 at the flagship (PERF.md): the
  // wide tile took 12.8, 10.0, 8.9 and 8.8 ms at 2, 4, 8 and 16; a tile of 8 rows 3.1 ms at 4
  // and 3.6 at 8.
  constexpr int kUnroll = C::kWide ? 8 : (RB >= 8 ? 4 : 8);
  const int vecs = N / 4;
  const int groups = (vecs + CV - 1) / CV;
  const int kc = (K + ks_count - 1) / ks_count;
  const int items = groups * RBN * ks_count;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    // Row blocks fastest: a warp's lanes share 32 / RBN weight vectors, whole 128-byte lines.
    const int rb = item % RBN, rest = item / RBN;
    const int cgp = rest % groups, ks = rest / groups;
    const int k0 = ks * kc;
    const int k1 = min(K, k0 + kc);
    // Vector v of group cgp is cgp + v * groups, so each of a warp's loads is one run of
    // vectors. The last groups of a layer may own fewer: they load the last one again, unused.
    int col[CV];
    bool own[CV];
#pragma unroll
    for (int v = 0; v < CV; ++v) {
      own[v] = cgp + v * groups < vecs;
      col[v] = 4 * min(cgp + v * groups, vecs - 1);
    }
    float acc[CV][4][RB];
#pragma unroll
    for (int v = 0; v < CV; ++v)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[v][c][r] = 0.f;
    const float* xp = in + rb * RB;
#pragma unroll kUnroll
    for (int k = k0; k < k1; ++k) {
      float wv[CV][4], x[RB];
#pragma unroll
      for (int v = 0; v < CV; ++v) load4(w + (long long)k * N + col[v], wv[v]);
      load_rows<RB, V>(xp + k * T, x);
#pragma unroll
      for (int v = 0; v < CV; ++v)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int r = 0; r < RB; ++r) acc[v][c][r] = fmaf(x[r], wv[v][c], acc[v][c][r]);
    }
#pragma unroll
    for (int v = 0; v < CV; ++v) {
      if (!own[v]) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = col[v] + c;
        if (ks_count == 1) {
          const float bias = b[n];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float h = acc[v][c][r] + bias;
            acc[v][c][r] = last ? h : activate(h, act);
          }
          store_rows<RB, V>(out + n * T + rb * RB, acc[v][c]);
        } else {
          store_rows<RB, V>(red + ((long long)ks * N + n) * T + rb * RB, acc[v][c]);
        }
      }
    }
  }
  if (ks_count > 1) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < N * T; idx += kThreads) {
      float sum = 0.f;
      for (int ks = 0; ks < ks_count; ++ks) sum += red[(long long)ks * N * T + idx];
      const float h = sum + b[idx / T];
      out[idx] = last ? h : activate(h, act);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// bfloat16 on the tensor cores. A warp takes MW 16-feature m tiles x NW 8-row n tiles over the
// whole K. `wf` is the layer's block in fragment order: [m tile][k tile][lane] of 16 bytes,
// a lane's registers a0..a3 of mma.m16n8k16 (A[m][k] = W[k][m]). `in` is [rows][in_stride]
// bf16. Hidden layers write bf16(f(acc + b)) to out [rows][out_stride]; the head (head !=
// nullptr) writes float32 acc + b to head [feature][T] for feature < out_w, row < T.
template <int T, int MW, int NW>
__device__ __forceinline__ void dense_mma_tiles(const __nv_bfloat16* in, int in_stride, int Kt,
                                                int Mt, int N, const uint4* __restrict__ wf,
                                                const float* __restrict__ b,
                                                __nv_bfloat16* out, int out_stride, float* head,
                                                int out_w, int act) {
  constexpr int NT = (T + 7) / 8;
  constexpr int n_groups = NT / NW;
  constexpr int kWarps = Cfg<T, __nv_bfloat16>::kWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int items = ((Mt + MW - 1) / MW) * n_groups;
  for (int item = warp; item < items; item += kWarps) {
    const int mt0 = (item / n_groups) * MW, nt0 = (item % n_groups) * NW;
    float acc[MW][NW][4];
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    const uint4* wa[MW];
#pragma unroll
    for (int i = 0; i < MW; ++i) wa[i] = wf + ((long long)min(mt0 + i, Mt - 1) * Kt) * 32 + lane;
    const __nv_bfloat16* xp = in + (nt0 * 8 + g) * in_stride + 2 * t;
#pragma unroll 4
    for (int kt = 0; kt < Kt; ++kt) {
      uint4 a[MW];
#pragma unroll
      for (int i = 0; i < MW; ++i) a[i] = wa[i][kt * 32];
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const __nv_bfloat16* xj = xp + j * 8 * in_stride + kt * 16;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xj);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xj + 8);
#pragma unroll
        for (int i = 0; i < MW; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      if (mt0 + i >= Mt) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int feature = (mt0 + i) * 16 + g + 8 * half;
        const float bias = feature < N ? b[feature] : 0.f;
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int row = (nt0 + j) * 8 + 2 * t + q;
            const float h = acc[i][j][2 * half + q] + bias;
            if (head != nullptr) {
              if (feature < out_w && row < T) head[feature * T + row] = h;
            } else {
              out[row * out_stride + feature] = __float2bfloat16_rn(activate(h, act));
            }
          }
      }
    }
  }
  __syncthreads();
}

template <int T>
__device__ void dense_mma(const __nv_bfloat16* in, int in_stride, int K, int N,
                          const __nv_bfloat16* __restrict__ w, const float* __restrict__ b,
                          __nv_bfloat16* out, int out_stride, float* head, int out_w, int act) {
  constexpr int NT = (T + 7) / 8;
  const int Kt = round_up16(K) / 16, Mt = round_up16(N) / 16;
  const uint4* wf = reinterpret_cast<const uint4*>(w);
  if (Mt >= 2 * Cfg<T, __nv_bfloat16>::kWarps) {
    dense_mma_tiles<T, 2, NT>(in, in_stride, Kt, Mt, N, wf, b, out, out_stride, head, out_w, act);
  } else {
    // A narrow layer (the head): one (m tile, n tile) pair per warp keeps more warps busy.
    dense_mma_tiles<T, 1, 1>(in, in_stride, Kt, Mt, N, wf, b, out, out_stride, head, out_w, act);
  }
}

// The CTA's shared memory. float32: x [in_w][T], buf0/buf1 [max_hidden][T], red
// [red_width][T]. bfloat16: x [TP][x_stride], buf0/buf1 [TP][h_stride] with TP = T rounded up
// to 8 (the padding rows are computed and never read), no red. Both: st [T][S] float32, head
// [2][slots][out_w][T] float32 (parity of the step, then the CTA's members). Every region
// starts 16-byte aligned. `tail` is where a kernel keeps its own buffers.
template <typename W>
struct StepSmem {
  float* st;
  W* x;
  float* head;
  W* buf0;
  W* buf1;
  float* red;
  float* tail;
  int slots, x_stride, h_stride;
};

struct StepBytes {
  size_t x, head, buf0, buf1, red, tail;
  int x_stride, h_stride;
};

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) / 16 * 16; }

template <int T, typename W>
__host__ __device__ __forceinline__ StepBytes step_bytes(const NetShape& net, int dim_s,
                                                         int slots) {
  StepBytes o;
  const int in_w = net.width[0], out_w = net.width[net.n_layers];
  o.x = align16(sizeof(float) * T * dim_s);
  size_t x_bytes, buf_bytes, red_bytes = 0;
  if constexpr (kIsBf16<W>) {
    constexpr int TP = (T + 7) / 8 * 8;
    o.x_stride = round_up16(in_w) + 8;
    o.h_stride = round_up16(net.max_hidden) + 8;
    x_bytes = sizeof(W) * TP * o.x_stride;
    buf_bytes = sizeof(W) * TP * o.h_stride;
  } else {
    o.x_stride = o.h_stride = T;
    x_bytes = sizeof(float) * in_w * T;
    buf_bytes = sizeof(float) * net.max_hidden * T;
    red_bytes = sizeof(float) * net.red_width * T;
  }
  o.head = o.x + align16(x_bytes);
  o.buf0 = o.head + align16(sizeof(float) * 2 * slots * out_w * T);
  o.buf1 = o.buf0 + align16(buf_bytes);
  o.red = o.buf1 + align16(buf_bytes);
  o.tail = o.red + align16(red_bytes);
  return o;
}

template <int T, typename W>
__device__ __forceinline__ StepSmem<W> carve(void* smem, const NetShape& net, int dim_s,
                                             int slots) {
  const StepBytes o = step_bytes<T, W>(net, dim_s, slots);
  char* base = static_cast<char*>(smem);
  StepSmem<W> s;
  s.st = reinterpret_cast<float*>(base);
  s.x = reinterpret_cast<W*>(base + o.x);
  s.head = reinterpret_cast<float*>(base + o.head);
  s.buf0 = reinterpret_cast<W*>(base + o.buf0);
  s.buf1 = reinterpret_cast<W*>(base + o.buf1);
  s.red = reinterpret_cast<float*>(base + o.red);
  s.tail = reinterpret_cast<float*>(base + o.tail);
  s.slots = slots;
  s.x_stride = o.x_stride;
  s.h_stride = o.h_stride;
  return s;
}

// One step for the tile: reads the state in sm.st and the actions action(r, j) (r < T, j < U),
// runs this CTA's members, waits for the cluster, sums the tile's heads, writes the next state
// into sm.st and, where out_t is not null, into out_t [T][S]. `parity` is the step's (t & 1).
// Ends with a barrier of the CTA.
template <int T, typename W, class ActionFn>
__device__ __forceinline__ void mlp_step(const StepSmem<W>& sm, ActionFn action,
                                         const float* __restrict__ stats,
                                         const W* __restrict__ weights,
                                         const float* __restrict__ biases, const Members& mb,
                                         int parity, float* __restrict__ out_t, const Problem& p,
                                         const NetShape& net) {
  constexpr int kThreads = Cfg<T, W>::kThreads;
  const int S = p.dim_s, U = p.dim_u, sw = p.stats_width;
  const int in_w = net.width[0], out_w = net.width[net.n_layers];
  auto input = [&](int k, int r) {
    float v = 0.f;
    if (k < S) {
      v = sm.st[r * S + k];
      if (p.normalized) v = (v - stats[k]) / (stats[sw + k] + kEps);
    } else if (k < S + U) {
      const int j = k - S;
      v = action(r, j);
      if (p.normalized) v = (v - stats[2 * sw + j]) / (stats[3 * sw + j] + kEps);
    }
    return v;
  };
  if constexpr (kIsBf16<W>) {
    constexpr int TP = (T + 7) / 8 * 8;
    const int in_p = round_up16(in_w);
    for (int i = threadIdx.x; i < TP * in_p; i += kThreads) {
      const int r = i / in_p, k = i % in_p;
      sm.x[r * sm.x_stride + k] = __float2bfloat16_rn(r < T ? input(k, r) : 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < in_w * T; i += kThreads) sm.x[i] = input(i / T, i % T);
  }
  __syncthreads();

  for (int i = mb.rank; i < mb.count; i += mb.stride) {
    const int e = mb.base + i;
    float* head = sm.head + ((long long)(parity * sm.slots + i / mb.stride) * out_w) * T;
    const W* in = sm.x;
    int in_stride = sm.x_stride;
    for (int l = 0; l < net.n_layers; ++l) {
      const int K = net.width[l], N = net.width[l + 1];
      const bool last = l == net.n_layers - 1;
      W* out = (l & 1) ? sm.buf1 : sm.buf0;
      const W* w = weights + net.w_off[l] + (long long)e * net.w_size[l];
      const float* b = biases + net.b_off[l] + (long long)e * N;
      if constexpr (kIsBf16<W>) {
        dense_mma<T>(in, in_stride, K, N, w, b, out, sm.h_stride, last ? head : nullptr, out_w,
                     p.activation);
      } else {
        // The head's partial sums go where its output would have gone: that buffer is free.
        float* red = (last && net.ks[l] * N > net.red_width) ? out : sm.red;
        dense<T>(in, K, N, net.ks[l], w, b, red, last ? head : out, last, p.activation);
      }
      in = out;
      in_stride = sm.h_stride;
    }
  }

  // Every member's head is written once the cluster (or, alone, the CTA) has passed here. The
  // heads of this parity are next written two steps on, past the next barrier, which no CTA
  // passes before every peer has finished reading below.
  cg::cluster_group cluster = cg::this_cluster();
  if (mb.stride > 1) cluster.sync();
  const long long slot_floats = (long long)out_w * T;
  for (int i = threadIdx.x; i < T * S; i += kThreads) {
    const int r = i / S, j = i % S;
    float sum = 0.f;
    for (int e = 0; e < mb.count; ++e) {
      const float* peer = mb.stride > 1 ? cluster.map_shared_rank(sm.head, e % mb.stride)
                                        : sm.head;
      sum += peer[(parity * sm.slots + e / mb.stride) * slot_floats + j * T + r];
    }
    float raw = sum / static_cast<float>(mb.count);
    if (p.normalized) raw = raw * (stats[5 * sw + j] + kEps) + stats[4 * sw + j];
    const float ns = p.predict_delta ? sm.st[i] + raw : raw;
    sm.st[i] = ns;
    if (out_t != nullptr) out_t[i] = ns;
  }
  __syncthreads();
}

// Fills `net` for a tile of T rows; false for a shape the kernels do not take.
template <int T>
bool make_shape(int n_layers, const int* widths, int ensemble, bool bf16, NetShape* net) {
  if (n_layers < 1 || n_layers > kMaxLayers || ensemble < 1) return false;
  net->n_layers = n_layers;
  long long w_off = 0, b_off = 0;
  int max_hidden = 4, red_width = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] <= 0 || widths[l] % 4) return false;
    net->width[l] = widths[l];
    if (l > 0 && l < n_layers && widths[l] > max_hidden) max_hidden = widths[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    const int K = widths[l], N = widths[l + 1];
    net->w_off[l] = w_off;
    net->b_off[l] = b_off;
    net->w_size[l] = bf16 ? (long long)round_up16(K) * round_up16(N) : (long long)K * N;
    w_off += ensemble * net->w_size[l];
    b_off += (long long)ensemble * N;
    net->ks[l] = bf16 ? 1 : k_slices<T>(K, N);
    if (l < n_layers - 1 && net->ks[l] > 1 && net->ks[l] * N > red_width) {
      red_width = net->ks[l] * N;
    }
  }
  // The head's partials fit the hidden layers' scratch or the free activation buffer.
  const int last = n_layers - 1, head_w = widths[n_layers];
  const int room = n_layers >= 2 && max_hidden > red_width ? max_hidden : red_width;
  if (net->ks[last] * head_w > room) net->ks[last] = room / head_w < 1 ? 1 : room / head_w;
  net->max_hidden = max_hidden;
  net->red_width = red_width;
  return true;
}

// What one launch configuration occupies: see bbmpc_rollout_occupancy.
struct Occupancy {
  int smem_bytes, blocks_per_sm, cluster, max_active_clusters, registers, local_bytes, threads;
};

// Launches `kern` with `tiles` clusters of `cluster` CTAs (E is a run-time value, so the
// cluster size is a launch attribute). With `occ`, fills it and launches nothing.
template <class... Params, class... Args>
cudaError_t launch_clusters(void (*kern)(Params...), int tiles, int cluster, int threads,
                            size_t smem, cudaStream_t stream, Occupancy* occ, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tiles * cluster);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  if (occ != nullptr) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return err;
    *occ = Occupancy{(int)smem, 0, cluster, 0, fa.numRegs, (int)fa.localSizeBytes, threads};
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ->blocks_per_sm, kern, threads,
                                                        smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(&occ->max_active_clusters, kern, &config);
  }
  err = cudaLaunchKernelEx(&config, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
