// Fused ensemble-MLP trajectory rollout for Hopper (sm_90a): K2 with K1 inside.
//
// Replaces ops/pallas_rollout.py::make_pallas_rollout_evaluator (its `kernel` and
// `kernel_streamed`) and the per-step chain ops/_kernel_common.py::build_step_fn of the JAX
// package. It computes what they compute, not block by block:
//
// * A tile of T rows stays in shared memory for the whole horizon, and the H loop inside the
//   kernel replaces the Pallas fori_loop and the sequential (tiles, H) grid axis. With mean
//   propagation the tile belongs to a thread-block cluster, one ensemble member per CTA; with
//   ts1 and ts_inf to one CTA that runs the tile's member.
// * ts_inf (PETS' TS-infinity, which the JAX kernels refuse) is ts1 with a Gaussian head: each
//   step samples mean + exp(logvar / 2) * noise[t, row] from the member's head, with the noise
//   [H, rows, S] an input that the caller draws (and lays out as the rows), so the kernel's
//   samples are the eager path's.
// * Each step is mlp_step() of mlp_step.cuh (K1), shared with the fused CEM kernels.
// * The kernel writes the visited states [H, rows, S]. It does not inline the reward: the JAX
//   kernel traces any jnp reward_fn into itself, a prebuilt CUDA library cannot call a Python
//   function. The wrapper (ops/rollout_kernel.py) applies the torch reward_fn to all H*rows
//   transitions at once and sums the discounted returns, which keeps
//   MPCPolicy(reward_function=...) general. At the flagship size the states are 3.4 MB per
//   launch against about 0.26 TFLOP of MLP work.
//
// What bounds it on the H100: the weights (5 x 3 x 500^2, 10.4 MB in f32, 5.2 MB in bf16) do
// not fit in a CTA's 227 KB of shared memory, the reverse of the VMEM-resident TPU design, so
// they stream from L2 (50 MB, where they stay resident) at every step. What a CTA streams is
// one member's 2.1 MB (f32), and every element of it feeds the tile's T rows: tiles x E x H x
// member bytes of L2 traffic per launch (11 GB at the flagship, T = 48, from 130 GB at 4 rows
// and all members per CTA). Measured (PERF.md): a float32 launch takes the same time for one
// cluster as for the 21 of the flagship, and nearly the same for 40 rows a tile as for 48, so
// neither L2 nor the FMA count bounds it; it is a CTA's own issue of FMAs and loads, at about
// 60 % of the rate its instruction stream allows, and deeper unrolling of the weight loads is
// what has moved it. Two things fix the tile: two float32 activation buffers of T rows must
// fit 227 KB (T <= 48 at 500 wide), and a cluster lives inside one GPC, so the card holds 22
// clusters of 5 CTAs at once (cudaOccupancyMaxActiveClusters) and the flagship's 1000 rows
// need T >= 46 to run in one wave. In bfloat16 the tensor cores take the FMAs, and the launch
// is bound by the weight fragments' way from L2 into registers. ts1 has one fifth of the work
// on the same rows, so its tile is small (8) to keep every SM busy, and it streams more weight
// bytes per FMA. ts_inf has its own tile (kTileTsInf, measured in ops/rollout_kernel.py): PETS'
// net gives a member 2000 rows, each tile of 40 re-streams the member's 528 KB of weights from
// L2 at every step, and its 200-wide layers split K over the lanes of a pair (dense_pairs in
// mlp_step.cuh). What bounds that loop is open (PERF.md): it keeps the FMA pipes about 40 %
// busy, shared-memory bank conflicts moved it, deeper weight prefetch did not.
// wgmma/TMA and a reward fused into the kernel are later work.

#include "mlp_step.cuh"

namespace {

// kSample: ts_inf, the tile's member sampled from its Gaussian head with `noise` [H, rows, S]
// and the log-variance bounds `lv_bounds` [2, S]; both unread otherwise. Its instantiation
// alone compiles swish layers (mlp_step.cuh's activate()).
template <int T, typename W, bool kSample>
__global__ void __launch_bounds__(Cfg<T, W>::kThreads, Cfg<T, W>::kMinBlocks)
rollout_kernel(const float* __restrict__ actions, const float* __restrict__ s0,
               const float* __restrict__ stats, const W* __restrict__ weights,
               const float* __restrict__ biases, const int* __restrict__ tile_member,
               const float* __restrict__ noise, const float* __restrict__ lv_bounds,
               float* __restrict__ states_out, Problem p, NetShape net) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ctas = cluster.num_blocks(), rank = cluster.block_rank();
  const int tile = blockIdx.x / n_ctas;
  const int S = p.dim_s, U = p.dim_u;
  const int row0 = tile * T;
  const Members mb = tile_members(tile_member ? tile_member[tile] : -1, p.ensemble, rank, n_ctas);
  const StepSmem<W> sm = carve<T, W>(smem4, net, S, head_slots(mb.count, mb.stride));

  for (int i = threadIdx.x; i < T * S; i += blockDim.x) sm.st[i] = s0[(long long)row0 * S + i];
  __syncthreads();

  for (int t = 0; t < p.horizon; ++t) {
    const float* a_t = actions + ((long long)t * p.rows + row0) * U;
    float* out_t = rank == 0 ? states_out + ((long long)t * p.rows + row0) * S : nullptr;
    Sample sample{};
    if constexpr (kSample) {
      // The step's noise into the tail of shared memory, its load hidden behind the layers.
      const float* noise_t = noise + ((long long)t * p.rows + row0) * S;
      for (int i = threadIdx.x; i < T * S; i += blockDim.x) copy_async(sm.tail + i, noise_t + i);
      sample = Sample{sm.tail, lv_bounds};
    }
    mlp_step<T, W, kSample, kSample>(
        sm, [=](int r, int j) { return a_t[r * U + j]; }, stats, weights, biases, mb, t & 1,
        out_t, p, net, sample);
  }
  // No CTA leaves while a peer may still read its heads.
  if (n_ctas > 1) cluster.sync();
}

template <int T, typename W, bool kSample = false>
cudaError_t launch(const float* actions, const float* s0, const float* stats,
                   const void* weights, const float* biases, const int* tile_member,
                   const float* noise, const float* lv_bounds, float* states_out,
                   const Problem& p, int n_layers, const int* widths, cudaStream_t stream,
                   Occupancy* occ) {
  NetShape net;
  if (!make_shape<T>(n_layers, widths, p.ensemble, kIsBf16<W>, &net) || p.rows % T) {
    return cudaErrorInvalidValue;
  }
  const int n_ctas = tile_member ? 1 : min(p.ensemble, kMaxCluster);
  const int slots = head_slots(tile_member ? 1 : p.ensemble, n_ctas);
  const size_t smem = step_bytes<T, W>(net, p.dim_s, slots).tail +
                      (kSample ? sizeof(float) * T * p.dim_s : 0);  // the step's noise
  return launch_clusters(rollout_kernel<T, W, kSample>, p.rows / T, n_ctas,
                         Cfg<T, W>::kThreads, smem, stream, occ, actions, s0, stats,
                         static_cast<const W*>(weights), biases, tile_member, noise, lv_bounds,
                         states_out, p, net);
}

cudaError_t rollout(const float* actions, const float* s0, const float* stats,
                    const void* weights, const float* biases, const int* tile_member,
                    const float* noise, const float* lv_bounds, float* states_out,
                    const Problem& p, int n_layers, const int* widths, int bf16, int tile,
                    cudaStream_t stream, Occupancy* occ) {
  // One tile per propagation; `tile_member` and `noise` are only tested against null here.
  if (noise != nullptr) {  // ts_inf: float32, one member per tile
    if (tile_member == nullptr || tile != kTileTsInf || bf16) return cudaErrorInvalidValue;
    return launch<kTileTsInf, float, true>(actions, s0, stats, weights, biases, tile_member,
                                           noise, lv_bounds, states_out, p, n_layers, widths,
                                           stream, occ);
  }
  if (p.activation == kSwishId) return cudaErrorInvalidValue;  // compiled for ts_inf alone
  if (tile_member != nullptr) {
    if (tile != kTileTs1) return cudaErrorInvalidValue;
    if (bf16) {
      return launch<kTileTs1, __nv_bfloat16>(actions, s0, stats, weights, biases, tile_member,
                                             nullptr, nullptr, states_out, p, n_layers, widths,
                                             stream, occ);
    }
    return launch<kTileTs1, float>(actions, s0, stats, weights, biases, tile_member, nullptr,
                                   nullptr, states_out, p, n_layers, widths, stream, occ);
  }
  if (tile != kTileMean) return cudaErrorInvalidValue;
  if (bf16) {
    return launch<kTileMean, __nv_bfloat16>(actions, s0, stats, weights, biases, tile_member,
                                            nullptr, nullptr, states_out, p, n_layers, widths,
                                            stream, occ);
  }
  return launch<kTileMean, float>(actions, s0, stats, weights, biases, tile_member, nullptr,
                                  nullptr, states_out, p, n_layers, widths, stream, occ);
}

}  // namespace

extern "C" {

// Rolls out `rows` rows (a multiple of `tile`) for `horizon` steps and writes the visited
// states. actions [H, rows, U], s0 [rows, S], stats [6, stats_width] and states_out
// [H, rows, S] are float32. `weights` holds every layer's E zero-padded blocks in the compute
// type, layer after layer: float32 (bf16 == 0) as [E, K, N] with K and N the padded `widths`;
// bfloat16 as [E, N16/16, K16/16, 32, 8], the mma.m16n8k16 A fragments of W^T with K and N
// padded to 16 (ops/rollout_kernel.py::fragment_pack). `biases` are the [E, N] float32 blocks.
// `tile_member` [rows / tile] gives each tile's member (ts1, ts_inf) or is NULL (mean: a cluster
// of min(E, 8) CTAs per tile). `noise` [H, rows, S] float32 makes the step ts_inf's (it needs
// `tile_member`, float32 and the head [mean S | raw log-variance S] of width `widths[n_layers]`
// >= 2 S), with `lv_bounds` [2, S] the log-variance bounds; NULL, both are unread. `tile` must
// be the tile compiled for that propagation. `widths` [n_layers + 1] are the padded layer
// widths. Returns the launch's error, 0 for none.
int bbmpc_rollout_states(const float* actions, const float* s0, const float* stats,
                         const void* weights, const float* biases, const int* tile_member,
                         const float* noise, const float* lv_bounds, float* states_out,
                         int horizon, int rows, int dim_s, int dim_u, int stats_width,
                         int ensemble, int n_layers, const int* widths, int activation,
                         int normalized, int predict_delta, int bf16, int tile, void* stream) {
  const Problem p{horizon, rows, dim_s, dim_u, stats_width, ensemble,
                  activation, normalized, predict_delta};
  if (noise != nullptr && (n_layers < 1 || widths[n_layers] < 2 * dim_s)) {
    return cudaErrorInvalidValue;
  }
  return rollout(actions, s0, stats, weights, biases, tile_member, noise, lv_bounds, states_out,
                 p, n_layers, widths, bf16, tile, static_cast<cudaStream_t>(stream), nullptr);
}

// What a launch of `rows` rows would occupy, without launching: out[0..6] = shared memory per
// CTA, resident CTAs per SM, CTAs per cluster, cudaOccupancyMaxActiveClusters, registers per
// thread, local (spill) bytes per thread, threads per CTA. `ts1` or `ts_inf` names the member
// tiles' kernel.
int bbmpc_rollout_occupancy(int rows, int dim_s, int ensemble, int n_layers, const int* widths,
                            int bf16, int ts1, int ts_inf, int tile, int* out) {
  const Problem p{1, rows, dim_s, 1, 1, ensemble, 0, 0, 0};
  const int some_member = 0;
  const float some_noise = 0.f;
  Occupancy occ{};
  const cudaError_t err =
      rollout(nullptr, nullptr, nullptr, nullptr, nullptr,
              ts1 || ts_inf ? &some_member : nullptr, ts_inf ? &some_noise : nullptr, nullptr,
              nullptr, p, n_layers, widths, bf16, tile, nullptr, &occ);
  out[0] = occ.smem_bytes;
  out[1] = occ.blocks_per_sm;
  out[2] = occ.cluster;
  out[3] = occ.max_active_clusters;
  out[4] = occ.registers;
  out[5] = occ.local_bytes;
  out[6] = occ.threads;
  return err;
}

}  // extern "C"
