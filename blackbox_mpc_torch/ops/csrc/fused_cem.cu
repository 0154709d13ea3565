// The generate-in-kernel CEM for Hopper (sm_90a): K3 (counter RNG), K4 (sample + rollout),
// K5 (the same, generating each step's actions inside the step) and K6 (regenerate the
// samples and reduce the elite moments).
//
// Replaces ops/pallas_cem.py of the JAX package: `_mix`, `_uniform`, `_normal`, `_gen_z`,
// `_tile_counter` (K3), `kernel_a` (K4), `kernel_a_streamed` (K5) and `kernel_b` (K6) of
// `make_fused_cem_kernels`, at its white-noise, normal-sampling path. The candidate tensor
// [P, A, H, U] is never stored: K6 regenerates each row's z from the same global counters
// (counter = row * H*U + h*U + u, row = p*A + a) that K4 drew it from.
//
// * K3: all integer arithmetic is uint32 (C++ int32 overflow is undefined, JAX wraps):
//   key = fmix32(seed), x = fmix32(counter * 0x9E3779B1 ^ key), u = (top 24 bits + 0.5) / 2^24.
//   Box-Muller takes its second uniform from key fmix32(seed + 0x632BE5AB), formed in uint32,
//   and z = clip(sqrt(-2 log u1) * cos(f32(2 pi) * u2), -2, 2) with logf/cosf/sqrtf at full
//   precision (no --use_fast_math). __fadd_rn/__fmul_rn keep the compiler from contracting
//   mean + std * z into an FMA, so the drawn actions round as the plain version's do.
// * K4/K5: one CTA per row tile of 4, as in K2 (rollout.cu), running mlp_step.cuh for every
//   horizon step. K4 generates the tile's whole z block [T, H*U] into shared memory before the
//   H loop (4.8 KB at the flagship) and forms the actions per row from its agent's mean/std;
//   K5 is the same CTA body (one template flag) that generates step h's [T, U] inside step h.
//   For ts1 a CTA runs member tile_member[row0 / member_tile], where member_tile is the JAX
//   kernel's logical tile (256 by default), so the member of every row is the JAX one.
// * The reward: as in K2, a prebuilt library cannot call the user's torch reward_fn. So K4/K5
//   write the visited states [H, rows, S] and the actions they drew [H, rows, U], time-major,
//   and the wrapper (ops/fused_cem.py) applies reward_fn to all H*rows transitions at once and
//   sums them undiscounted. The JAX kernel never stores the candidates; this is the one
//   deliberate divergence (1.2 MB of actions at the flagship). Fusing a fixed reward form is
//   later work.
// * K6: a two-pass deterministic reduction. Pass 1 gives each thread one (agent, column) pair
//   over one chunk of population indices: it regenerates z for the rows of its agent
//   (row = p*A + a), forms centered = std * z and writes the chunk's sum of w*centered and of
//   w*centered^2. Pass 2 adds the chunks in a fixed order. No atomics, so repeated runs give
//   the same bits. The weights w are a 0/1 elite mask for CEM, or any weights.
//
// What bounds them on the H100: K4/K5 by the same L2 weight streaming as K2 (every CTA reads
// every member's weights from L2 at every step; the RNG adds about 1e-4 of the MLP's work).
// K6 moves a few KB and draws H*U*rows normals: it is bound by launch latency and the RNG
// arithmetic (two fmix32, logf, cosf, sqrtf per element).

#include "mlp_step.cuh"

namespace {

constexpr int kMomentThreads = 128;
constexpr float kTwoPi = 6.283185307179586f;  // f32(2 pi), as JAX's weak-typed product rounds it

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform01(uint32_t counter, uint32_t key) {
  const uint32_t x = fmix32((counter * 0x9E3779B1u) ^ key);
  return __fmul_rn(__fadd_rn(static_cast<float>(x >> 8), 0.5f), 1.0f / 16777216.0f);
}

struct Keys {
  uint32_t k1, k2;
};

__device__ __forceinline__ Keys make_keys(const int* seed) {
  const uint32_t s = static_cast<uint32_t>(*seed);
  return Keys{fmix32(s), fmix32(s + 0x632BE5ABu)};
}

// Clipped N(0, 1) of one element counter.
__device__ __forceinline__ float normal_z(uint32_t counter, const Keys& keys) {
  const float u1 = uniform01(counter, keys.k1);
  const float u2 = uniform01(counter, keys.k2);
  const float g = __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))), cosf(__fmul_rn(kTwoPi, u2)));
  return fminf(fmaxf(g, -2.0f), 2.0f);
}

// The action of row `row`, flat column c = h*U + u, from its agent's mean/std. Also stored to
// actions_out [H, rows, U].
__device__ __forceinline__ float draw_action(int row, int c, int hu, int agents,
                                             const float* __restrict__ mean,
                                             const float* __restrict__ std, const Keys& keys,
                                             float* __restrict__ actions_out, const Problem& p) {
  const int a = row % agents;
  const float z = normal_z(static_cast<uint32_t>(row) * static_cast<uint32_t>(hu) +
                               static_cast<uint32_t>(c),
                           keys);
  const float v = __fadd_rn(mean[a * hu + c], __fmul_rn(std[a * hu + c], z));
  const int h = c / p.dim_u, u = c % p.dim_u;
  actions_out[((long long)h * p.rows + row) * p.dim_u + u] = v;
  return v;
}

template <int T, typename W, bool kStreamed>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ mean,
                     const float* __restrict__ std, const int* __restrict__ seed,
                     const int* __restrict__ tile_member, int member_tile, int agents,
                     const float* __restrict__ stats, const W* __restrict__ weights,
                     const float* __restrict__ biases, float* __restrict__ states_out,
                     float* __restrict__ actions_out, Problem p, NetShape net) {
  extern __shared__ float4 smem4[];
  const StepSmem sm = carve<T>(reinterpret_cast<float*>(smem4), net, p.dim_s);
  float* acts = sm.tail;  // K4: [T][H*U]; K5: [T][U]
  const int S = p.dim_s, U = p.dim_u, hu = p.horizon * p.dim_u;
  const int row0 = blockIdx.x * T;
  const int member = tile_member ? tile_member[row0 / member_tile] : -1;
  const Keys keys = make_keys(seed);

  for (int i = threadIdx.x; i < T * S; i += kThreads) {
    const int r = i / S, j = i % S;
    sm.st[i] = s0[((row0 + r) % agents) * S + j];
  }
  if (!kStreamed) {
    for (int i = threadIdx.x; i < T * hu; i += kThreads) {
      acts[i] = draw_action(row0 + i / hu, i % hu, hu, agents, mean, std, keys, actions_out, p);
    }
  }
  __syncthreads();

  for (int t = 0; t < p.horizon; ++t) {
    if (kStreamed) {
      for (int i = threadIdx.x; i < T * U; i += kThreads) {
        acts[i] =
            draw_action(row0 + i / U, t * U + i % U, hu, agents, mean, std, keys, actions_out, p);
      }
      __syncthreads();
    }
    const float* a_t = kStreamed ? acts : acts + t * U;
    mlp_step<T, W>(sm, a_t, kStreamed ? U : hu, stats, weights, biases, member,
                   states_out + ((long long)t * p.rows + row0) * S, p, net);
  }
}

// Pass 1 of K6: partial[chunk][0|1][a*hu + c] = sum over p in the chunk of w * x and w * x^2,
// x = std[a, c] * z(row = p*A + a, c).
__global__ void __launch_bounds__(kMomentThreads)
elite_partial_kernel(const float* __restrict__ std, const float* __restrict__ weight,
                     const int* __restrict__ seed, int population, int agents, int hu, int chunk,
                     float* __restrict__ partial) {
  const int n = agents * hu;
  const int idx = blockIdx.y * kMomentThreads + threadIdx.x;
  if (idx >= n) return;
  const int a = idx / hu, c = idx % hu;
  const Keys keys = make_keys(seed);
  const float sd = std[idx];
  const int p0 = blockIdx.x * chunk;
  const int p1 = min(population, p0 + chunk);
  float sum = 0.f, sumsq = 0.f;
  for (int p = p0; p < p1; ++p) {
    const int row = p * agents + a;
    const float w = weight[row];
    const float x = sd * normal_z(static_cast<uint32_t>(row) * static_cast<uint32_t>(hu) +
                                      static_cast<uint32_t>(c),
                                  keys);
    sum += w * x;
    sumsq += w * (x * x);
  }
  float* out = partial + (long long)blockIdx.x * 2 * n;
  out[idx] = sum;
  out[n + idx] = sumsq;
}

// Pass 2 of K6: the chunks in order.
__global__ void __launch_bounds__(kMomentThreads)
elite_final_kernel(const float* __restrict__ partial, int n_chunks, int n,
                   float* __restrict__ sum_out, float* __restrict__ sumsq_out) {
  const int idx = blockIdx.x * kMomentThreads + threadIdx.x;
  if (idx >= n) return;
  float sum = 0.f, sumsq = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    sum += partial[(long long)k * 2 * n + idx];
    sumsq += partial[(long long)k * 2 * n + n + idx];
  }
  sum_out[idx] = sum;
  sumsq_out[idx] = sumsq;
}

template <int T, typename W, bool kStreamed>
cudaError_t launch(const float* s0, const float* mean, const float* std, const int* seed,
                   const int* tile_member, int member_tile, int agents, const float* stats,
                   const void* weights, const float* biases, float* states_out,
                   float* actions_out, const Problem& p, const NetShape& net,
                   cudaStream_t stream) {
  const int tail = kStreamed ? T * p.dim_u : T * p.horizon * p.dim_u;
  const size_t smem = smem_bytes(net, p.dim_s, T) + (size_t)tail * sizeof(float);
  auto kern = fused_rollout_kernel<T, W, kStreamed>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<p.rows / T, kThreads, smem, stream>>>(s0, mean, std, seed, tile_member, member_tile,
                                               agents, stats, static_cast<const W*>(weights),
                                               biases, states_out, actions_out, p, net);
  return cudaGetLastError();
}

template <bool kStreamed>
int fused_rollout(const float* s0, const float* mean, const float* std, const int* seed,
                  const int* tile_member, int member_tile, const float* stats,
                  const void* weights, const float* biases, float* states_out,
                  float* actions_out, int horizon, int rows, int agents, int dim_s, int dim_u,
                  int stats_width, int ensemble, int n_layers, const int* widths,
                  int activation, int normalized, int predict_delta, int bf16, void* stream) {
  NetShape net;
  if (!make_shape(n_layers, widths, ensemble, &net) || rows % kTile || agents < 1 ||
      (tile_member && (member_tile <= 0 || member_tile % kTile))) {
    return cudaErrorInvalidValue;
  }
  const Problem p{horizon, rows, dim_s, dim_u, stats_width, ensemble,
                  activation, normalized, predict_delta};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<kTile, __nv_bfloat16, kStreamed>(s0, mean, std, seed, tile_member,
                                                   member_tile, agents, stats, weights, biases,
                                                   states_out, actions_out, p, net, s);
  }
  return launch<kTile, float, kStreamed>(s0, mean, std, seed, tile_member, member_tile, agents,
                                         stats, weights, biases, states_out, actions_out, p,
                                         net, s);
}

}  // namespace

extern "C" {

// K4. Draws the actions of `rows` rows (a multiple of 4; row = p * agents + a, agent-minor)
// from the counter RNG under `seed` [1] (int32, on the device) and the per-agent mean/std
// [agents, H*U], rolls them out from s0 [agents, S] for `horizon` steps, and writes the visited
// states [H, rows, S] and the drawn actions [H, rows, U]. `tile_member` [ceil(rows /
// member_tile)] gives each logical tile of `member_tile` rows (a multiple of 4) its member
// (ts1), or is NULL (mean). Weights, biases, stats and widths are as in bbmpc_rollout_states.
// Returns cudaGetLastError().
int bbmpc_fused_rollout(const float* s0, const float* mean, const float* std, const int* seed,
                        const int* tile_member, int member_tile, const float* stats,
                        const void* weights, const float* biases, float* states_out,
                        float* actions_out, int horizon, int rows, int agents, int dim_s,
                        int dim_u, int stats_width, int ensemble, int n_layers,
                        const int* widths, int activation, int normalized, int predict_delta,
                        int bf16, void* stream) {
  return fused_rollout<false>(s0, mean, std, seed, tile_member, member_tile, stats, weights,
                              biases, states_out, actions_out, horizon, rows, agents, dim_s,
                              dim_u, stats_width, ensemble, n_layers, widths, activation,
                              normalized, predict_delta, bf16, stream);
}

// K5: the same function as K4, generating step h's actions inside step h.
int bbmpc_fused_rollout_streamed(const float* s0, const float* mean, const float* std,
                                 const int* seed, const int* tile_member, int member_tile,
                                 const float* stats, const void* weights, const float* biases,
                                 float* states_out, float* actions_out, int horizon, int rows,
                                 int agents, int dim_s, int dim_u, int stats_width,
                                 int ensemble, int n_layers, const int* widths, int activation,
                                 int normalized, int predict_delta, int bf16, void* stream) {
  return fused_rollout<true>(s0, mean, std, seed, tile_member, member_tile, stats, weights,
                             biases, states_out, actions_out, horizon, rows, agents, dim_s,
                             dim_u, stats_width, ensemble, n_layers, widths, activation,
                             normalized, predict_delta, bf16, stream);
}

// K6. sum_out/sumsq_out [agents, hu] = sum over the population of weight[row] * x and
// weight[row] * x^2, x = std[a] * z(row), row = p * agents + a; weight [population * agents].
// `partial` is scratch of ceil(population / chunk) * 2 * agents * hu floats.
int bbmpc_elite_moments(const float* std, const float* weight, const int* seed, float* partial,
                        float* sum_out, float* sumsq_out, int population, int agents, int hu,
                        int chunk, void* stream) {
  if (population < 1 || agents < 1 || hu < 1 || chunk < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = agents * hu;
  const int n_chunks = (population + chunk - 1) / chunk;
  const int col_blocks = (n + kMomentThreads - 1) / kMomentThreads;
  elite_partial_kernel<<<dim3(n_chunks, col_blocks), kMomentThreads, 0, s>>>(
      std, weight, seed, population, agents, hu, chunk, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  elite_final_kernel<<<col_blocks, kMomentThreads, 0, s>>>(partial, n_chunks, n, sum_out,
                                                           sumsq_out);
  return cudaGetLastError();
}

}  // extern "C"
