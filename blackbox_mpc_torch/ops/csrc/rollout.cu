// Fused ensemble-MLP trajectory rollout for Hopper (sm_90a): K2 with K1 inside.
//
// Replaces ops/pallas_rollout.py::make_pallas_rollout_evaluator (its `kernel` and
// `kernel_streamed`) and the per-step chain ops/_kernel_common.py::build_step_fn of the JAX
// package. It computes what they compute, not block by block:
//
// * One CTA owns a tile of T rows and loops over the H horizon steps itself. That loop
//   replaces the Pallas fori_loop and the sequential (tiles, H) grid axis. The tile's state
//   stays in shared memory for the whole horizon.
// * Per step: normalize (eps 1e-7) -> E-member MLP (tanh/relu/gelu, float32 accumulation,
//   float32 bias, activation then cast to the compute type) -> member mean, or the tile's one
//   member for ts1 -> denormalize -> delta. Activations ping-pong between two shared-memory
//   buffers, laid out [feature][row] so one 16-byte load gives four rows of one feature.
// * The kernel writes the visited states [H, rows, S]. It does not inline the reward: the JAX
//   kernel traces any jnp reward_fn into itself, a prebuilt CUDA library cannot call a Python
//   function. The wrapper (ops/rollout_kernel.py) applies the torch reward_fn to all H*rows
//   transitions at once and sums the discounted returns, which keeps
//   MPCPolicy(reward_function=...) general. At the flagship size the states are 3.4 MB per
//   launch against about 0.26 TFLOP of MLP work.
//
// What bounds it on the H100: the weights (5 x 3 x 500^2, 10.4 MB in f32, 5.2 MB in bf16) do
// not fit in a CTA's 227 KB of shared memory, the reverse of the VMEM-resident TPU design. So
// every CTA reads every member's weights from L2 (50 MB, where they stay resident) at every
// step: tiles x H x weight bytes of L2 traffic. A larger tile cuts that traffic but leaves SMs
// idle at the flagship's 1000 rows. The matmuls are SIMT float32 FMA loops: each thread
// owns 4 output columns x T rows in registers, reads its 4 weights with one vector load, and
// splits K across threads (a narrow layer such as the 17-wide head splits most), so all 512
// threads work. Measured on the H100 at the flagship (PERF.md), the loop is bound by L2
// latency more than by L2 bandwidth: 512 threads per CTA and an 8-deep k-unroll (more
// weight loads in flight) cut a launch from 20.7 to 12.3 ms, and tile 4 (2 CTAs per SM)
// beat tile 8 despite twice the L2 traffic. Tile 16 needs more than the 128 registers a
// thread may hold at 512 threads. So the tile is 4; a second tile comes back only with a
// measured batch on each side of the rule that would pick it.
// Operands in bf16 are rounded values held in float32; a product of two bf16 values is exact
// in float32, so this is the bf16 matmul with float32 accumulation of the JAX kernel.
// wgmma/TMA and a reward fused into the kernel are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 4;  // rows per CTA
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

template <int T, typename W>
__global__ void __launch_bounds__(kThreads)
rollout_kernel(const float* __restrict__ actions, const float* __restrict__ s0,
               const float* __restrict__ stats, const W* __restrict__ weights,
               const float* __restrict__ biases, const int* __restrict__ tile_member,
               float* __restrict__ states_out, Problem p, NetShape net) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = p.dim_s, U = p.dim_u, sw = p.stats_width;
  const int in_w = net.width[0], out_w = net.width[net.n_layers];
  float* st = smem;               // [T][S] carried state
  float* x = st + T * S;          // [in_w][T] network input
  float* acc = x + in_w * T;      // [out_w][T] head output (member sum)
  float* buf0 = acc + out_w * T;  // [max_hidden][T]
  float* buf1 = buf0 + net.max_hidden * T;
  float* red = buf1 + net.max_hidden * T;  // [red_width][T] partial sums
  const int row0 = blockIdx.x * T;
  const int member = tile_member ? tile_member[blockIdx.x] : -1;
  const int e_begin = member < 0 ? 0 : member;
  const int e_end = member < 0 ? p.ensemble : member + 1;

  for (int i = threadIdx.x; i < T * S; i += kThreads) st[i] = s0[(long long)row0 * S + i];
  __syncthreads();

  for (int t = 0; t < p.horizon; ++t) {
    const float* a_t = actions + ((long long)t * p.rows + row0) * U;
    for (int i = threadIdx.x; i < in_w * T; i += kThreads) {
      const int k = i / T, r = i % T;
      float v = 0.f;
      if (k < S) {
        v = st[r * S + k];
        if (p.normalized) v = (v - stats[k]) / (stats[sw + k] + kEps);
      } else if (k < S + U) {
        const int j = k - S;
        v = a_t[r * U + j];
        if (p.normalized) v = (v - stats[2 * sw + j]) / (stats[3 * sw + j] + kEps);
      }
      x[i] = round_to(v, weights);
    }
    for (int i = threadIdx.x; i < out_w * T; i += kThreads) acc[i] = 0.f;
    __syncthreads();

    for (int e = e_begin; e < e_end; ++e) {
      const float* in = x;
      for (int l = 0; l < net.n_layers; ++l) {
        const int K = net.width[l], N = net.width[l + 1];
        const bool last = l == net.n_layers - 1;
        float* out = last ? acc : ((l & 1) ? buf1 : buf0);
        dense<T>(in, K, N, weights + net.w_off[l] + (long long)e * K * N,
                 biases + net.b_off[l] + (long long)e * N, red, out,
                 last ? kAccumulate : kActivate, p.activation);
        in = out;
      }
    }

    float* out_t = states_out + ((long long)t * p.rows + row0) * S;
    for (int i = threadIdx.x; i < T * S; i += kThreads) {
      const int r = i / S, j = i % S;
      float raw = acc[j * T + r];
      if (member < 0) raw = raw / static_cast<float>(p.ensemble);
      if (p.normalized) raw = raw * (stats[5 * sw + j] + kEps) + stats[4 * sw + j];
      const float ns = p.predict_delta ? st[i] + raw : raw;
      st[i] = ns;
      out_t[i] = ns;
    }
    __syncthreads();
  }
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

size_t smem_bytes(const NetShape& net, int dim_s, int tile) {
  const long long floats = (long long)tile * (dim_s + net.width[0] + net.width[net.n_layers] +
                                              2LL * net.max_hidden + net.red_width);
  return (size_t)floats * sizeof(float);
}

template <int T, typename W>
cudaError_t launch(const float* actions, const float* s0, const float* stats,
                   const void* weights, const float* biases, const int* tile_member,
                   float* states_out, const Problem& p, const NetShape& net,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(net, p.dim_s, T);
  auto kern = rollout_kernel<T, W>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<p.rows / T, kThreads, smem, stream>>>(actions, s0, stats,
                                               static_cast<const W*>(weights), biases,
                                               tile_member, states_out, p, net);
  return cudaGetLastError();
}

template <int T, typename W>
cudaError_t occupancy(const NetShape& net, int dim_s, int* blocks_per_sm) {
  const size_t smem = smem_bytes(net, dim_s, T);
  auto kern = rollout_kernel<T, W>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, kThreads, smem);
}

}  // namespace

extern "C" {

// Rolls out `rows` rows (a multiple of 4, the tile) for `horizon` steps and writes the visited
// states. actions [H, rows, U], s0 [rows, S], stats [6, stats_width] and states_out
// [H, rows, S] are float32; `weights` is every layer's zero-padded [E, K, N] block in the
// compute type (bf16 != 0: bfloat16, else float32), back to back; `biases` the [E, N] float32
// blocks. `tile_member` [rows / 4] gives each tile's member (ts1) or is NULL (mean).
// `widths` [n_layers + 1] are the padded layer widths. Returns cudaGetLastError().
int bbmpc_rollout_states(const float* actions, const float* s0, const float* stats,
                         const void* weights, const float* biases, const int* tile_member,
                         float* states_out, int horizon, int rows, int dim_s, int dim_u,
                         int stats_width, int ensemble, int n_layers, const int* widths,
                         int activation, int normalized, int predict_delta, int bf16,
                         void* stream) {
  NetShape net;
  if (!make_shape(n_layers, widths, ensemble, &net) || rows % kTile) return cudaErrorInvalidValue;
  const Problem p{horizon, rows, dim_s, dim_u, stats_width, ensemble,
                  activation, normalized, predict_delta};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<kTile, __nv_bfloat16>(actions, s0, stats, weights, biases, tile_member,
                                        states_out, p, net, s);
  }
  return launch<kTile, float>(actions, s0, stats, weights, biases, tile_member, states_out, p,
                              net, s);
}

// Shared memory per CTA and resident CTAs per SM of one launch configuration.
int bbmpc_rollout_occupancy(int dim_s, int ensemble, int n_layers, const int* widths, int bf16,
                            int* smem, int* blocks_per_sm) {
  NetShape net;
  if (!make_shape(n_layers, widths, ensemble, &net)) return cudaErrorInvalidValue;
  *smem = (int)smem_bytes(net, dim_s, kTile);
  if (bf16) return occupancy<kTile, __nv_bfloat16>(net, dim_s, blocks_per_sm);
  return occupancy<kTile, float>(net, dim_s, blocks_per_sm);
}

}  // extern "C"
