// Fused ensemble-MLP trajectory rollout for Hopper (sm_90a): K2 with K1 inside.
//
// Replaces ops/pallas_rollout.py::make_pallas_rollout_evaluator (its `kernel` and
// `kernel_streamed`) and the per-step chain ops/_kernel_common.py::build_step_fn of the JAX
// package. It computes what they compute, not block by block:
//
// * One CTA owns a tile of T rows and loops over the H horizon steps itself. That loop
//   replaces the Pallas fori_loop and the sequential (tiles, H) grid axis. The tile's state
//   stays in shared memory for the whole horizon.
// * Each step is mlp_step() of mlp_step.cuh (K1), shared with the fused CEM kernels.
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
// idle at the flagship's 1000 rows. Measured on the H100 at the flagship (PERF.md), the loop
// is bound by L2 latency more than by L2 bandwidth: 512 threads per CTA and an 8-deep k-unroll
// (more weight loads in flight) cut a launch from 20.7 to 12.3 ms, and tile 4 (2 CTAs per SM,
// kMinBlocks) beat tile 8 despite twice the L2 traffic. Tile 16 needs more than the 128
// registers a thread may hold at 512 threads. So the tile is 4; a second tile comes back only
// with a measured batch on each side of the rule that would pick it.
// wgmma/TMA and a reward fused into the kernel are later work.

#include "mlp_step.cuh"

namespace {

template <int T, typename W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rollout_kernel(const float* __restrict__ actions, const float* __restrict__ s0,
               const float* __restrict__ stats, const W* __restrict__ weights,
               const float* __restrict__ biases, const int* __restrict__ tile_member,
               float* __restrict__ states_out, Problem p, NetShape net) {
  extern __shared__ float4 smem4[];
  const StepSmem sm = carve<T>(reinterpret_cast<float*>(smem4), net, p.dim_s);
  const int S = p.dim_s, U = p.dim_u;
  const int row0 = blockIdx.x * T;
  const int member = tile_member ? tile_member[blockIdx.x] : -1;

  for (int i = threadIdx.x; i < T * S; i += kThreads) sm.st[i] = s0[(long long)row0 * S + i];
  __syncthreads();

  for (int t = 0; t < p.horizon; ++t) {
    mlp_step<T, W>(sm, actions + ((long long)t * p.rows + row0) * U, U, stats, weights, biases,
                   member, states_out + ((long long)t * p.rows + row0) * S, p, net);
  }
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
