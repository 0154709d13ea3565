// One horizon step of the ensemble-MLP dynamics for a tile of rows, shared by the rollout
// kernel (rollout.cu, K2) and the fused CEM kernels (fused_cem.cu, K4/K5). It is K1 of the JAX
// package: ops/_kernel_common.py::build_step_fn, without the reward.
//
// Per step: normalize (eps 1e-7) -> E-member MLP (tanh/relu/gelu, float32 accumulation,
// float32 bias, activation then cast to the compute type) -> member mean, or the tile's one
// member for ts1 -> denormalize -> delta. Activations ping-pong between two shared-memory
// buffers, laid out [feature][row] so one 16-byte load gives four rows of one feature.
//
// The matmuls are SIMT float32 FMA loops: each thread owns 4 output columns x T rows in
// registers, reads its 4 weights with one vector load, and splits K across threads (a narrow
// layer such as the 17-wide head splits most), so all 512 threads work. Operands in bf16 are
// rounded values held in float32; a product of two bf16 values is exact in float32, so this is
// the bf16 matmul with float32 accumulation of the JAX kernel. What bounds the loop on the
// H100 (L2 latency of the weight stream) is in rollout.cu's note.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 4;  // rows per CTA
// CTAs per SM that the tile-4 design counts on (1000 rows = 250 CTAs, all resident on 132 SMs).
// Declared in each kernel's __launch_bounds__: without it ptxas picked a register allocation
// for this code that ran K2 16 % slower on the H100 (PERF.md).
constexpr int kMinBlocks = 2;
constexpr int kMaxLayers = 8;
constexpr float kEps = 1e-7f;

struct NetShape {
  int n_layers;
  int width[kMaxLayers + 1];    // padded widths (multiples of 4): input, hidden..., output
  long long w_off[kMaxLayers];  // element offset of layer l's [E, K, N] weight block
  long long b_off[kMaxLayers];  // element offset of layer l's [E, N] bias block
  int max_hidden;               // widest padded hidden layer (>= 4)
  int red_width;                // partial-sum scratch width: max over layers of ks * N
};

struct Problem {
  int horizon, rows, dim_s, dim_u, stats_width, ensemble;
  int activation, normalized, predict_delta;
};

__device__ __forceinline__ void load4(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&w)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = lo.x; w[1] = lo.y; w[2] = hi.x; w[3] = hi.y;
}

__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float activate(float x, int act) {
  if (act == 0) return tanhf(x);
  if (act == 1) return x < 0.f ? 0.f : x;
  // jax.nn.gelu's default tanh approximation.
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return x * (0.5f * (1.f + tanhf(c * (x + 0.044715f * (x * x * x)))));
}

// Split of K across threads for a layer of padded width n: ks slices, n/4 column groups.
__host__ __device__ __forceinline__ int k_slices(int k, int n) {
  int ks = kThreads / (n / 4);
  if (ks < 1) ks = 1;
  if (ks > k) ks = k;
  return ks;
}

enum Store { kActivate = 0, kAccumulate = 1 };

// out[n*T + r] (+)= f(sum_k in[k*T + r] * w[k*N + n] + b[n]) for n < N, r < T.
template <int T, typename W>
__device__ void dense(const float* in, int K, int N, const W* __restrict__ w,
                      const float* __restrict__ b, float* red, float* out, Store store,
                      int act) {
  const int groups = N / 4;
  const int ks_count = k_slices(K, N);
  const int kc = (K + ks_count - 1) / ks_count;
  for (int item = threadIdx.x; item < groups * ks_count; item += kThreads) {
    const int cg = item % groups, ks = item / groups;
    const int k0 = ks * kc;
    const int k1 = min(K, k0 + kc);
    float acc[4][T];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < T; ++r) acc[c][r] = 0.f;
    const W* wp = w + cg * 4;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      float wv[4];
      load4(wp + (long long)k * N, wv);
      float x[T];
#pragma unroll
      for (int r = 0; r < T; r += 4) {
        const float4 v = *reinterpret_cast<const float4*>(in + k * T + r);
        x[r] = v.x; x[r + 1] = v.y; x[r + 2] = v.z; x[r + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < T; ++r) acc[c][r] = fmaf(x[r], wv[c], acc[c][r]);
    }
    float* dst = red + (long long)ks * N * T + cg * 4 * T;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < T; r += 4)
        *reinterpret_cast<float4*>(dst + c * T + r) =
            make_float4(acc[c][r], acc[c][r + 1], acc[c][r + 2], acc[c][r + 3]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * T; idx += kThreads) {
    float sum = 0.f;
    for (int ks = 0; ks < ks_count; ++ks) sum += red[(long long)ks * N * T + idx];
    const float h = sum + b[idx / T];
    if (store == kActivate) {
      out[idx] = round_to(activate(h, act), w);
    } else {
      out[idx] += h;
    }
  }
  __syncthreads();
}

// The CTA's shared memory, carved in this order. Every region is a multiple of T floats
// (T = 4), so each starts 16-byte aligned. `tail` is where a kernel keeps its own buffers.
struct StepSmem {
  float* st;    // [T][S] carried state
  float* x;     // [in_w][T] network input
  float* acc;   // [out_w][T] head output (member sum)
  float* buf0;  // [max_hidden][T]
  float* buf1;  // [max_hidden][T]
  float* red;   // [red_width][T] partial sums
  float* tail;
};

template <int T>
__device__ __forceinline__ StepSmem carve(float* smem, const NetShape& net, int dim_s) {
  StepSmem s;
  s.st = smem;
  s.x = s.st + T * dim_s;
  s.acc = s.x + net.width[0] * T;
  s.buf0 = s.acc + net.width[net.n_layers] * T;
  s.buf1 = s.buf0 + net.max_hidden * T;
  s.red = s.buf1 + net.max_hidden * T;
  s.tail = s.red + net.red_width * T;
  return s;
}

// One step for the tile: reads the state in sm.st and the actions a_t[r * a_stride + j]
// (j < U), writes the next state into sm.st and into out_t [T][S]. `member` < 0 runs every
// member and takes their mean; otherwise that member alone (ts1). Ends with a barrier.
template <int T, typename W>
__device__ __forceinline__ void mlp_step(const StepSmem& sm, const float* a_t, int a_stride,
                                         const float* __restrict__ stats,
                                         const W* __restrict__ weights,
                                         const float* __restrict__ biases, int member,
                                         float* __restrict__ out_t, const Problem& p,
                                         const NetShape& net) {
  const int S = p.dim_s, U = p.dim_u, sw = p.stats_width;
  const int in_w = net.width[0], out_w = net.width[net.n_layers];
  const int e_begin = member < 0 ? 0 : member;
  const int e_end = member < 0 ? p.ensemble : member + 1;
  for (int i = threadIdx.x; i < in_w * T; i += kThreads) {
    const int k = i / T, r = i % T;
    float v = 0.f;
    if (k < S) {
      v = sm.st[r * S + k];
      if (p.normalized) v = (v - stats[k]) / (stats[sw + k] + kEps);
    } else if (k < S + U) {
      const int j = k - S;
      v = a_t[r * a_stride + j];
      if (p.normalized) v = (v - stats[2 * sw + j]) / (stats[3 * sw + j] + kEps);
    }
    sm.x[i] = round_to(v, weights);
  }
  for (int i = threadIdx.x; i < out_w * T; i += kThreads) sm.acc[i] = 0.f;
  __syncthreads();

  for (int e = e_begin; e < e_end; ++e) {
    const float* in = sm.x;
    for (int l = 0; l < net.n_layers; ++l) {
      const int K = net.width[l], N = net.width[l + 1];
      const bool last = l == net.n_layers - 1;
      float* out = last ? sm.acc : ((l & 1) ? sm.buf1 : sm.buf0);
      dense<T>(in, K, N, weights + net.w_off[l] + (long long)e * K * N,
               biases + net.b_off[l] + (long long)e * N, sm.red, out,
               last ? kAccumulate : kActivate, p.activation);
      in = out;
    }
  }

  for (int i = threadIdx.x; i < T * S; i += kThreads) {
    const int r = i / S, j = i % S;
    float raw = sm.acc[j * T + r];
    if (member < 0) raw = raw / static_cast<float>(p.ensemble);
    if (p.normalized) raw = raw * (stats[5 * sw + j] + kEps) + stats[4 * sw + j];
    const float ns = p.predict_delta ? sm.st[i] + raw : raw;
    sm.st[i] = ns;
    out_t[i] = ns;
  }
  __syncthreads();
}

bool make_shape(int n_layers, const int* widths, int ensemble, NetShape* net) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  net->n_layers = n_layers;
  long long w_off = 0, b_off = 0;
  int max_hidden = 4, red_width = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] <= 0 || widths[l] % 4) return false;
    net->width[l] = widths[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    const int K = widths[l], N = widths[l + 1];
    net->w_off[l] = w_off;
    net->b_off[l] = b_off;
    w_off += (long long)ensemble * K * N;
    b_off += (long long)ensemble * N;
    if (l < n_layers - 1 && N > max_hidden) max_hidden = N;
    const int r = k_slices(K, N) * N;
    if (r > red_width) red_width = r;
  }
  net->max_hidden = max_hidden;
  net->red_width = red_width;
  return true;
}

// Bytes of the regions of StepSmem, without the tail.
size_t smem_bytes(const NetShape& net, int dim_s, int tile) {
  const long long floats = (long long)tile * (dim_s + net.width[0] + net.width[net.n_layers] +
                                              2LL * net.max_hidden + net.red_width);
  return (size_t)floats * sizeof(float);
}

}  // namespace
