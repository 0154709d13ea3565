// The generate-in-kernel solver family for Hopper (sm_90a): K3 (counter RNG), K4 (sample +
// rollout), K5 (the same, generating each step's actions inside the step) and K6 (regenerate
// the samples and reduce the weighted moments).
//
// Replaces ops/pallas_cem.py of the JAX package: `_mix`, `_uniform`, `_normal`, `_gen_z`,
// `_tile_counter` (K3), `kernel_a` (K4), `kernel_a_streamed` (K5) and `kernel_b` (K6) of
// `make_fused_cem_kernels`, with every option of theirs: white, colored and uniform sampling,
// the bounds clip with its squared-violation penalty, injected candidates and the MPPI dot.
// The candidate tensor [P, A, H, U] is never stored: K6 regenerates each row's z from the same
// global counters (counter = row * n_cols + col, row = p*A + a) that K4 drew it from.
//
// * K3: all integer arithmetic is uint32 (C++ int32 overflow is undefined, JAX wraps):
//   key = fmix32(seed), x = fmix32(counter * 0x9E3779B1 ^ key), u = (top 24 bits + 0.5) / 2^24.
//   Box-Muller takes its second uniform from key fmix32(seed + 0x632BE5AB), formed in uint32,
//   and z = clip(sqrt(-2 log u1) * cos(f32(2 pi) * u2), -2, 2) with logf/cosf/sqrtf at full
//   precision (no --use_fast_math). __fadd_rn/__fmul_rn keep the compiler from contracting
//   mean + std * z into an FMA, so the drawn actions round as the plain version's do.
//   `gen_z_tile` yields a tile's z [T, H*U] for K4, `draw_z_rows` that of any T rows for K6
//   and `draw_rows_kernel`, with the same bits. White (n_cols = H*U) and
//   uniform (2u - 1 from the first key) are per element. Colored is per row: n_cols = U*2F
//   unclipped normals, each action dim's 2F normals contracted with the [2F, H] spectral basis
//   (the block that the JAX kernel's dense [U*2F, H*U] matrix repeats per action dim; 10.4 KB at
//   the flagship, in shared memory when it fits), then the row's mean and population std, the
//   division by std + 1e-8 and the clip at +/-2. The contraction is a chain of fmaf in k order
//   and the row sums are lane-strided with a butterfly, all in explicit round-to-nearest
//   intrinsics, so K4, K6 and K3 alone get the same bits whatever their block sizes.
// * K4/K5: a tile of T rows per cluster (mean: one member per CTA) or per CTA (ts1), as in K2
//   (rollout.cu), running mlp_step.cuh for every horizon step. K4 draws the tile's actions for
//   all H steps before the H loop, in sub-tiles of 8 rows that the CTAs of the cluster share
//   out, straight into actions_out; the H loop reads step t's [T, U] back from there (L2), so
//   no action stays in shared memory and the prologue's scratch lies over the step's buffers.
//   K5 is the same CTA body (one template flag) that draws step h's [T, U] where step h builds
//   the network's input, every CTA of the cluster for itself (same counters, same bits), and
//   rank 0 stores them. Rank 0 alone stores the states.
//   For ts1 a CTA runs member tile_member[row0 / member_tile], where member_tile is the JAX
//   kernel's logical tile (256 by default), so the member of every row is the JAX one.
//   The options live in a second instantiation of K4 (template flag kFlagged), whose prologue
//   branches at run time and whose H loop is the plain one: one warp per row clips to the
//   bounds and sums (raw - clipped)^2, overrides injected rows (population index >= population
//   - extra_slots) from `extra`, and sums <gvec, centered> with centered taken after the clip,
//   each sum lane-strided with a butterfly, so in a fixed order.
// * The reward: as in K2, a prebuilt library cannot call the user's torch reward_fn. So K4/K5
//   write the visited states [H, rows, S] and the actions they ended up with [H, rows, U],
//   time-major, and the wrapper (ops/fused_cem.py) applies reward_fn to all H*rows transitions
//   at once, sums them undiscounted and subtracts the penalty. The JAX kernel never stores the
//   candidates; this is the one deliberate divergence (1.2 MB of actions at the flagship).
//   Fusing a fixed reward form is later work.
// * K6: sum_w w*centered and sum_w w*centered^2 per (agent, column), in one launch of
//   thread-block clusters of kMomentCluster CTAs, with no scratch in device memory and no
//   atomics, so two runs give the same bits. The weights w are a 0/1 elite mask (CEM),
//   softmax weights (PI2, MPPI) or log-rank weights (sep-CMA); a row of weight 0 (+0 or -0)
//   adds nothing to a finite sum, so it is not drawn. CTA `rank` of a cluster takes the
//   rank-th contiguous span of the population and walks it in chunks of one index per thread:
//   a warp ballot over 32 weights and a prefix over the warps compact the chunk's rows of
//   weight into shared memory, in increasing order, and only those are drawn. Where z is per
//   element (white or uniform, with or without the clip and injected rows),
//   `moments_cols_kernel` runs a cluster per (agent, block of 32 columns): lane l takes column
//   l, warp w the compacted rows w, w + 8, ..., and the warps' sums are added in warp order. A
//   colored z needs its whole row, so `moments_rows_kernel` runs a cluster per agent that draws
//   the compacted rows kMomentTile at a time through `draw_z_rows`, each thread adding its
//   columns over them in order. centered = std*z, clip(mean + std*z) - mean with the bounds
//   clip, and extra - mean on injected rows (drawn by no one in the per-element kernel). Last,
//   rank 0 adds the CTAs' sums over distributed shared memory in rank order and writes them.
// * K3 on its own, `draw_rows_kernel`: z of a list of rows, kDrawTile rows per CTA, through
//   `draw_z_rows`, so a row's z has K4's bits. The solvers read carried elites, the
//   execute-best plan and RandomSearch's argmax row with it.
//
// What bounds them on the H100: K4/K5 as K2 (rollout.cu's note): in float32 a CTA's own FMA
// and load issue and the clusters one wave holds, in bfloat16 the weight fragments' way from
// L2. The RNG adds about 1e-4 of the MLP's work, the colored contraction 2F multiply-adds per
// element. K6 moves a few KB: the weights, std and mean in, two [A, H*U] sums out. What is
// left is launch latency (one launch where there were two, and no allocation) and the draws
// of the rows of weight, each two fmix32, a logf, a cosf and a sqrtf per element: 50 x H*U at
// CEM's and sep-CMA's flagship in place of 1000 x H*U, all of them for MPPI and PI2, whose
// weights are nowhere 0. The per-element kernel spreads them over agents x ceil(H*U / 32)
// clusters of 8 CTAs (80 SMs at the flagship); the colored one has only 8 CTAs per agent, so
// with dense weights its draws, not the launch, set its time. draw_rows draws a few rows: it
// is launch latency alone.

#include "mlp_step.cuh"

namespace {

constexpr int kMomentThreads = 256;  // K6: 8 warps, and a chunk of 256 population indices
constexpr int kMomentWarps = kMomentThreads / 32;
constexpr int kMomentCluster = 8;    // K6: CTAs that split a population, the portable size
constexpr int kMomentCols = 32;      // K6 per element: columns of a cluster, one per lane
constexpr int kMomentTile = 8;       // K6 colored: rows drawn at a time, a warp each
constexpr int kDrawThreads = 256;    // draw_rows_kernel
constexpr int kDrawTile = 4;         // draw_rows_kernel: rows per CTA
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

// N(0, 1) of one element counter by Box-Muller, unclipped.
__device__ __forceinline__ float normal_raw(uint32_t counter, const Keys& keys) {
  const float u1 = uniform01(counter, keys.k1);
  const float u2 = uniform01(counter, keys.k2);
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))), cosf(__fmul_rn(kTwoPi, u2)));
}

__device__ __forceinline__ float clip2(float g) { return fminf(fmaxf(g, -2.0f), 2.0f); }

// Clipped N(0, 1) of one element counter.
__device__ __forceinline__ float normal_z(uint32_t counter, const Keys& keys) {
  return clip2(normal_raw(counter, keys));
}

enum Sampling { kWhite = 0, kUniform = 1, kColored = 2 };

// The options of K4 and K6. A null pointer switches its option off.
struct Features {
  int sampling;        // Sampling
  int n_cols;          // RNG counters per row: H*U, or U*2F when colored
  int two_f;           // rows of the spectral basis, 2 * (H/2 + 1) (colored)
  int basis_in_smem;   // the kernel copies the basis into shared memory first
  const float* basis;  // [2F, H] (colored)
  const float* extra;  // [extra_slots * agents, H*U] injected candidates
  int extra_slots;     // the last extra_slots population indices read `extra`
  int population;
  const float* clip;   // [2, U]: lower, upper
  const float* gvec;   // [agents, H*U]
  float* penalty_out;  // [rows], written with clip
  float* dot_out;      // [rows], written with gvec
};

// Sum over the warp in a fixed order; every lane gets it.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// K3 for a tile: z [T][H*U] of the rows row0 + r * row_stride, r < n_rows (the rest get 0).
// `g` is scratch [T][n_cols] for the colored draw; `basis` is [2F][H]. Ends with a barrier.
// Nothing here depends on the block size, so K4 and K6 get the same bits.
template <int T>
__device__ __forceinline__ void gen_z_tile(float* z, float* g, const float* basis,
                                           const Features& f, int horizon, int dim_u,
                                           uint32_t row0, uint32_t row_stride, int n_rows,
                                           const Keys& keys) {
  const int hu = horizon * dim_u;
  const int nt = blockDim.x;
  if (f.sampling != kColored) {
    for (int i = threadIdx.x; i < T * hu; i += nt) {
      const int r = i / hu, c = i % hu;
      float v = 0.f;
      if (r < n_rows) {
        const uint32_t counter = (row0 + static_cast<uint32_t>(r) * row_stride) *
                                     static_cast<uint32_t>(hu) +
                                 static_cast<uint32_t>(c);
        v = f.sampling == kUniform
                ? __fadd_rn(__fmul_rn(2.0f, uniform01(counter, keys.k1)), -1.0f)
                : normal_z(counter, keys);
      }
      z[i] = v;
    }
    __syncthreads();
    return;
  }
  const int nc = f.n_cols, two_f = f.two_f;
  for (int i = threadIdx.x; i < T * nc; i += nt) {
    const int r = i / nc, col = i % nc;
    g[i] = r < n_rows ? normal_raw((row0 + static_cast<uint32_t>(r) * row_stride) *
                                           static_cast<uint32_t>(nc) +
                                       static_cast<uint32_t>(col),
                                   keys)
                      : 0.f;
  }
  __syncthreads();
  // Action dim u's 2F normals through the basis: column c = h*U + u.
  for (int i = threadIdx.x; i < T * hu; i += nt) {
    const int r = i / hu, c = i % hu;
    const int h = c / dim_u, u = c % dim_u;
    const float* gr = g + r * nc + u * two_f;
    float acc = 0.f;
    for (int k = 0; k < two_f; ++k) acc = fmaf(gr[k], basis[k * horizon + h], acc);
    z[i] = acc;
  }
  __syncthreads();
  // One warp per row: unit population std over the whole (H, U) sequence, then the clip.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = nt / 32;
  const float n = static_cast<float>(hu);
  for (int r = warp; r < T; r += n_warps) {
    float* zr = z + r * hu;
    float s = 0.f;
    for (int c = lane; c < hu; c += 32) s = __fadd_rn(s, zr[c]);
    const float mu = __fdiv_rn(warp_sum(s), n);
    float q = 0.f;
    for (int c = lane; c < hu; c += 32) {
      const float d = __fsub_rn(zr[c], mu);
      q = fmaf(d, d, q);
    }
    const float sd = sqrtf(fmaxf(__fdiv_rn(warp_sum(q), n), 0.f));
    const float denom = __fadd_rn(sd, 1e-8f);
    for (int c = lane; c < hu; c += 32) zr[c] = clip2(__fdiv_rn(zr[c], denom));
  }
  __syncthreads();
}

// Copies n floats from global to shared memory, eight loads in flight a thread.
__device__ __forceinline__ void copy_to_shared(float* dst, const float* __restrict__ src, int n) {
  constexpr int kBatch = 8;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * blockDim.x) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      v[j] = i < n ? src[i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n) dst[i] = v[j];
    }
  }
}

// K3 for K6 and draw_rows_kernel: z [T][H*U] of the rows row_of(r) (uint32), r < n_rows (the
// rest are not written), with gen_z_tile's bits. K4 keeps gen_z_tile for itself: a change to
// its prologue moves the register allocation of its H loop (1 % slower with options, measured).
// Here the loops keep more in flight: four draws a thread, the colored contraction by column
// over all T rows with each basis element loaded once and k unrolled by four, and the row
// statistics' loads ahead of their adds. Every element is still the same chain of fmaf in k
// order, and every row sum gen_z_tile's. Ends with a barrier.
template <int T, class RowOf>
__device__ __forceinline__ void draw_z_rows(float* z, float* g, const float* basis,
                                            const Features& f, int horizon, int dim_u,
                                            RowOf row_of, int n_rows, const Keys& keys) {
  const int hu = horizon * dim_u;
  const int nt = blockDim.x;
  if (f.sampling != kColored) {
#pragma unroll 4
    for (int i = threadIdx.x; i < n_rows * hu; i += nt) {
      const uint32_t counter =
          row_of(i / hu) * static_cast<uint32_t>(hu) + static_cast<uint32_t>(i % hu);
      z[i] = f.sampling == kUniform
                 ? __fadd_rn(__fmul_rn(2.0f, uniform01(counter, keys.k1)), -1.0f)
                 : normal_z(counter, keys);
    }
    __syncthreads();
    return;
  }
  const int nc = f.n_cols, two_f = f.two_f;
#pragma unroll 4
  for (int i = threadIdx.x; i < n_rows * nc; i += nt) {
    g[i] = normal_raw(row_of(i / nc) * static_cast<uint32_t>(nc) + static_cast<uint32_t>(i % nc),
                      keys);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < hu; c += nt) {
    const int h = c / dim_u, u = c % dim_u;
    const float* gc = g + u * two_f;
    float acc[T];
#pragma unroll
    for (int r = 0; r < T; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < two_f; ++k) {
      const float b = basis[k * horizon + h];
#pragma unroll
      for (int r = 0; r < T; ++r) acc[r] = fmaf(gc[r * nc + k], b, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < T; ++r) {
      if (r < n_rows) z[r * hu + c] = acc[r];
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = nt / 32;
  const float n = static_cast<float>(hu);
  for (int r = warp; r < n_rows; r += n_warps) {
    float* zr = z + r * hu;
    float s = 0.f;
#pragma unroll 4
    for (int c = lane; c < hu; c += 32) s = __fadd_rn(s, zr[c]);
    const float mu = __fdiv_rn(warp_sum(s), n);
    float q = 0.f;
#pragma unroll 4
    for (int c = lane; c < hu; c += 32) {
      const float d = __fsub_rn(zr[c], mu);
      q = fmaf(d, d, q);
    }
    const float sd = sqrtf(fmaxf(__fdiv_rn(warp_sum(q), n), 0.f));
    const float denom = __fadd_rn(sd, 1e-8f);
#pragma unroll 4
    for (int c = lane; c < hu; c += 32) zr[c] = clip2(__fdiv_rn(zr[c], denom));
  }
  __syncthreads();
}

// K4's options, one warp per row of the tile: turns the z block in `acts` [T][H*U] into the
// actions the rollout takes (clipped to the bounds, or the injected candidate), stores them to
// actions_out [H, rows, U], and writes the row's penalty and dot.
template <int T>
__device__ __forceinline__ void form_actions(float* acts, int row0, int agents, int hu,
                                             const float* __restrict__ mean,
                                             const float* __restrict__ std, const Features& f,
                                             float* actions_out, const Problem& p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  const int U = p.dim_u;
  const int fresh = f.population - f.extra_slots;
  for (int r = warp; r < T; r += n_warps) {
    const int row = row0 + r, a = row % agents, pi = row / agents;
    // The grid's padding rows have pi >= population: they never read `extra`.
    const bool injected = f.extra != nullptr && pi >= fresh && pi < f.population;
    const float* inj =
        injected ? f.extra + ((long long)(pi - fresh) * agents + a) * hu : nullptr;
    float pen = 0.f, dot = 0.f;
    for (int c = lane; c < hu; c += 32) {
      const float m = mean[a * hu + c];
      const float dev = __fmul_rn(std[a * hu + c], acts[r * hu + c]);
      float v = __fadd_rn(m, dev);
      float centered = dev;
      if (f.clip != nullptr) {
        const int u = c % U;
        const float clipped = fminf(fmaxf(v, f.clip[u]), f.clip[U + u]);
        const float d = __fsub_rn(v, clipped);
        pen = fmaf(d, d, pen);
        v = clipped;
        centered = __fsub_rn(v, m);
      }
      if (injected) {
        v = inj[c];
        centered = __fsub_rn(v, m);
      }
      if (f.gvec != nullptr) dot = fmaf(f.gvec[a * hu + c], centered, dot);
      acts[r * hu + c] = v;
      actions_out[((long long)(c / U) * p.rows + row) * U + c % U] = v;
    }
    pen = warp_sum(pen);
    dot = warp_sum(dot);
    if (lane == 0) {
      if (f.penalty_out != nullptr) f.penalty_out[row] = pen;
      if (f.dot_out != nullptr) f.dot_out[row] = dot;
    }
  }
}

// Rows of K4's prologue at a time: the tile is drawn in sub-tiles of this many rows, so that its
// scratch (z, the colored draw's normals, the basis) does not grow with the tile.
__host__ __device__ constexpr int draw_sub_tile(int tile) { return tile % 8 == 0 ? 8 : 4; }

// The action of row `row`, flat column c = h*U + u, from its agent's mean/std. Where `store`,
// also written to actions_out [H, rows, U].
__device__ __forceinline__ float draw_action(int row, int c, int hu, int agents,
                                             const float* __restrict__ mean,
                                             const float* __restrict__ std, const Keys& keys,
                                             bool store, float* actions_out, const Problem& p) {
  const int a = row % agents;
  const float z = normal_z(static_cast<uint32_t>(row) * static_cast<uint32_t>(hu) +
                               static_cast<uint32_t>(c),
                           keys);
  const float v = __fadd_rn(mean[a * hu + c], __fmul_rn(std[a * hu + c], z));
  const int h = c / p.dim_u, u = c % p.dim_u;
  if (store) actions_out[((long long)h * p.rows + row) * p.dim_u + u] = v;
  return v;
}

// K4's prologue: the tile's actions, all H steps of them, into actions_out [H, rows, U] (and
// with options the penalty and the dot). The tile is drawn in sub-tiles of draw_sub_tile(T)
// rows, which the CTAs of the cluster share out; nothing of it stays in shared memory, and the H
// loop reads step t's [T, U] back from actions_out (they are in L2). `scratch` is the CTA's
// whole shared memory, free before the H loop: z [TS][H*U], then with the colored draw its
// normals [TS][n_cols] and, if kept in shared memory, the [2F][H] basis.
template <int T, bool kFlagged>
__device__ __forceinline__ void sample_tile(float* scratch, int row0, int rank, int n_ctas,
                                            int agents, const float* __restrict__ mean,
                                            const float* __restrict__ std, const Keys& keys,
                                            const Features& f, float* actions_out,
                                            const Problem& p) {
  constexpr int TS = draw_sub_tile(T);
  static_assert(T % TS == 0, "the tile is a whole number of draw sub-tiles");
  const int hu = p.horizon * p.dim_u;
  if constexpr (kFlagged) {
    float* g = scratch + TS * hu;
    const float* basis = f.basis;
    if (f.basis_in_smem) {
      float* b = g + TS * f.n_cols;
      for (int i = threadIdx.x; i < f.two_f * p.horizon; i += blockDim.x) b[i] = f.basis[i];
      basis = b;
    }
    for (int sub = rank; sub < T / TS; sub += n_ctas) {
      const int sub0 = row0 + sub * TS;
      gen_z_tile<TS>(scratch, g, basis, f, p.horizon, p.dim_u, static_cast<uint32_t>(sub0), 1u,
                     TS, keys);
      form_actions<TS>(scratch, sub0, agents, hu, mean, std, f, actions_out, p);
      __syncthreads();
    }
  } else {
    for (int sub = rank; sub < T / TS; sub += n_ctas) {
      const int sub0 = row0 + sub * TS;
      for (int i = threadIdx.x; i < TS * hu; i += blockDim.x) {
        draw_action(sub0 + i / hu, i % hu, hu, agents, mean, std, keys, true, actions_out, p);
      }
    }
  }
}

template <int T, typename W, bool kStreamed, bool kFlagged>
__global__ void __launch_bounds__(Cfg<T, W>::kThreads, Cfg<T, W>::kMinBlocks)
fused_rollout_kernel(const float* __restrict__ s0, const float* __restrict__ mean,
                     const float* __restrict__ std, const int* __restrict__ seed,
                     const int* __restrict__ tile_member, int member_tile, int agents,
                     const float* __restrict__ stats, const W* __restrict__ weights,
                     const float* __restrict__ biases, float* __restrict__ states_out,
                     float* actions_out, Problem p, NetShape net, Features f) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ctas = cluster.num_blocks(), rank = cluster.block_rank();
  const int S = p.dim_s, U = p.dim_u, hu = p.horizon * p.dim_u;
  const int row0 = (blockIdx.x / n_ctas) * T;
  const Members mb = tile_members(tile_member ? tile_member[row0 / member_tile] : -1,
                                  p.ensemble, rank, n_ctas);
  const StepSmem<W> sm = carve<T, W, false>(smem4, net, S, head_slots(mb.count, mb.stride));
  const Keys keys = make_keys(seed);

  if (!kStreamed) {
    sample_tile<T, kFlagged>(reinterpret_cast<float*>(smem4), row0, rank, n_ctas, agents, mean,
                             std, keys, f, actions_out, p);
    // The peers' actions are in global memory, and the scratch is free, past this barrier.
    if (n_ctas > 1) cluster.sync(); else __syncthreads();
  }
  for (int i = threadIdx.x; i < T * S; i += blockDim.x) {
    const int r = i / S, j = i % S;
    sm.st[i] = s0[((row0 + r) % agents) * S + j];
  }
  __syncthreads();

  for (int t = 0; t < p.horizon; ++t) {
    float* out_t = rank == 0 ? states_out + ((long long)t * p.rows + row0) * S : nullptr;
    if (kStreamed) {
      // The step draws its own [T, U] where it builds the network's input, every CTA of the
      // cluster for itself: same counters, same bits. Rank 0 stores them.
      mlp_step<T, W>(
          sm,
          [&](int r, int j) {
            return draw_action(row0 + r, t * U + j, hu, agents, mean, std, keys, rank == 0,
                               actions_out, p);
          },
          stats, weights, biases, mb, t & 1, out_t, p, net);
    } else {
      // Written in this launch by another thread, maybe of another CTA: read from L2.
      const float* a_t = actions_out + ((long long)t * p.rows + row0) * U;
      mlp_step<T, W>(
          sm, [=](int r, int j) { return __ldcg(a_t + r * U + j); }, stats, weights, biases, mb,
          t & 1, out_t, p, net);
    }
  }
  // No CTA leaves while a peer may still read its heads.
  if (n_ctas > 1) cluster.sync();
}

// K6: the rank-th of kMomentCluster contiguous spans of the population, [p0, p1). The K6
// kernels are launched in clusters of kMomentCluster CTAs.
struct Span {
  int p0, p1;
};

__device__ __forceinline__ Span population_span(int population, int rank) {
  return Span{static_cast<int>((long long)population * rank / kMomentCluster),
              static_cast<int>((long long)population * (rank + 1) / kMomentCluster)};
}

// K6: the CTAs' values at `x` in their shared memory, added in rank order. All loads are
// issued before the first add.
__device__ __forceinline__ float sum_over_ranks(cg::cluster_group& cluster, float* x) {
  float v[kMomentCluster];
#pragma unroll
  for (int r = 0; r < kMomentCluster; ++r) v[r] = *cluster.map_shared_rank(x, r);
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < kMomentCluster; ++r) sum = __fadd_rn(sum, v[r]);
  return sum;
}

// K6: compacts the population indices p of [c0, min(c0 + blockDim, p1)) whose weight (of row
// p * agents + a) is not 0, +0 or -0, into sel/selw, in increasing order: a ballot per warp,
// then a prefix over the warps' counts. Returns their count. Starts and ends with a barrier.
__device__ __forceinline__ int compact_weighted(int c0, int p1, const float* __restrict__ weight,
                                                int agents, int a, int* sel, float* selw,
                                                int* counts) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  const int p = c0 + static_cast<int>(threadIdx.x);
  const float w = p < p1 ? weight[(long long)p * agents + a] : 0.f;
  const bool keep = w != 0.f;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  __syncthreads();  // the previous chunk's sel and counts are read
  if (lane == 0) counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
  for (int k = 0; k < n_warps; ++k) {
    before += k < warp ? counts[k] : 0;
    total += counts[k];
  }
  if (keep) {
    const int i = before + __popc(ballot & ((1u << lane) - 1u));
    sel[i] = p;
    selw[i] = w;
  }
  __syncthreads();
  return total;
}

// K6 where z is drawn per element (white or uniform; with or without the clip and injected
// rows): a cluster per (agent, block of kMomentCols columns), see the note at the top.
__global__ void __launch_bounds__(kMomentThreads)
moments_cols_kernel(const float* __restrict__ mean, const float* __restrict__ std,
                    const float* __restrict__ weight, const int* __restrict__ seed,
                    int population, int agents, int horizon, int dim_u, Features f,
                    float* __restrict__ sum_out, float* __restrict__ sumsq_out) {
  __shared__ int sel[kMomentThreads];
  __shared__ float selw[kMomentThreads];
  __shared__ int counts[kMomentWarps];
  __shared__ float part[kMomentWarps][2][kMomentCols];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int hu = horizon * dim_u;
  const int col_blocks = (hu + kMomentCols - 1) / kMomentCols;
  const int id = blockIdx.x / kMomentCluster;
  const int a = id / col_blocks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = (id % col_blocks) * kMomentCols + lane;
  const int c = min(col, hu - 1);  // a lane past the last column draws it again, unused
  const float sd = std[a * hu + c];
  const float m = mean != nullptr ? mean[a * hu + c] : 0.f;
  const float lo = f.clip != nullptr ? f.clip[c % dim_u] : 0.f;
  const float hi = f.clip != nullptr ? f.clip[dim_u + c % dim_u] : 0.f;
  const int fresh = population - f.extra_slots;
  const Keys keys = make_keys(seed);
  const Span span = population_span(population, rank);
  float sum = 0.f, sumsq = 0.f;
  for (int c0 = span.p0; c0 < span.p1; c0 += kMomentThreads) {
    const int n = compact_weighted(c0, span.p1, weight, agents, a, sel, selw, counts);
#pragma unroll 4
    for (int i = warp; i < n; i += kMomentWarps) {
      const int p = sel[i];
      float x;
      if (f.extra != nullptr && p >= fresh) {
        x = __fsub_rn(f.extra[((long long)(p - fresh) * agents + a) * hu + c], m);
      } else {
        const uint32_t row =
            static_cast<uint32_t>(p) * static_cast<uint32_t>(agents) + static_cast<uint32_t>(a);
        const uint32_t counter = row * static_cast<uint32_t>(hu) + static_cast<uint32_t>(c);
        const float z = f.sampling == kUniform
                            ? __fadd_rn(__fmul_rn(2.0f, uniform01(counter, keys.k1)), -1.0f)
                            : normal_z(counter, keys);
        x = __fmul_rn(sd, z);
        if (f.clip != nullptr) x = __fsub_rn(fminf(fmaxf(__fadd_rn(m, x), lo), hi), m);
      }
      const float w = selw[i];
      sum = fmaf(w, x, sum);
      sumsq = fmaf(w, __fmul_rn(x, x), sumsq);
    }
  }
  part[warp][0][lane] = sum;
  part[warp][1][lane] = sumsq;
  __syncthreads();
  const int k = threadIdx.x / kMomentCols, l = threadIdx.x % kMomentCols;
  if (threadIdx.x < 2 * kMomentCols) {
    float v = 0.f;
    for (int w = 0; w < kMomentWarps; ++w) v = __fadd_rn(v, part[w][k][l]);
    part[0][k][l] = v;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x < 2 * kMomentCols) {
    const float v = sum_over_ranks(cluster, &part[0][k][l]);
    const int out_col = (id % col_blocks) * kMomentCols + l;
    if (out_col < hu) (k == 0 ? sum_out : sumsq_out)[a * hu + out_col] = v;
  }
  cluster.sync();  // no CTA leaves while rank 0 reads its sums
}

// K6 with the colored draw: a cluster per agent; each CTA draws its span's rows of weight T at
// a time through draw_z_rows and adds each column over them in order, see the note at the top.
template <int T>
__global__ void __launch_bounds__(kMomentThreads)
moments_rows_kernel(const float* __restrict__ mean, const float* __restrict__ std,
                    const float* __restrict__ weight, const int* __restrict__ seed,
                    int population, int agents, int horizon, int dim_u, Features f,
                    float* __restrict__ sum_out, float* __restrict__ sumsq_out) {
  extern __shared__ float4 smem4[];
  __shared__ int sel[kMomentThreads];
  __shared__ float selw[kMomentThreads];
  __shared__ int counts[kMomentWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int hu = horizon * dim_u;
  float* z = reinterpret_cast<float*>(smem4);  // [T][H*U]
  float* acc = z + T * hu;                     // [2][H*U]
  float* g = acc + 2 * hu;                     // [T][n_cols]
  const float* basis = f.basis;
  if (f.basis_in_smem) {
    float* b = g + T * f.n_cols;
    copy_to_shared(b, f.basis, f.two_f * horizon);
    basis = b;
  }
  for (int c = threadIdx.x; c < 2 * hu; c += blockDim.x) acc[c] = 0.f;
  const int a = blockIdx.x / kMomentCluster;
  const int fresh = population - f.extra_slots;
  const Keys keys = make_keys(seed);
  const Span span = population_span(population, rank);
  const int* rows = sel;
  for (int c0 = span.p0; c0 < span.p1; c0 += kMomentThreads) {
    const int n = compact_weighted(c0, span.p1, weight, agents, a, sel, selw, counts);
    for (int t0 = 0; t0 < n; t0 += T) {
      const int n_rows = min(T, n - t0);
      draw_z_rows<T>(
          z, g, basis, f, horizon, dim_u,
          [=](int r) {
            return static_cast<uint32_t>(rows[t0 + r]) * static_cast<uint32_t>(agents) +
                   static_cast<uint32_t>(a);
          },
          n_rows, keys);
      for (int c = threadIdx.x; c < hu; c += blockDim.x) {
        const float m = mean != nullptr ? mean[a * hu + c] : 0.f;
        const float sd = std[a * hu + c];
        float sum = acc[c], sumsq = acc[hu + c];
        for (int r = 0; r < n_rows; ++r) {
          const int p = sel[t0 + r];
          float x = __fmul_rn(sd, z[r * hu + c]);
          if (f.clip != nullptr) {
            const int u = c % dim_u;
            x = __fsub_rn(fminf(fmaxf(__fadd_rn(m, x), f.clip[u]), f.clip[dim_u + u]), m);
          }
          if (f.extra != nullptr && p >= fresh) {
            x = __fsub_rn(f.extra[((long long)(p - fresh) * agents + a) * hu + c], m);
          }
          sum = fmaf(selw[t0 + r], x, sum);
          sumsq = fmaf(selw[t0 + r], __fmul_rn(x, x), sumsq);
        }
        acc[c] = sum;
        acc[hu + c] = sumsq;
      }
      __syncthreads();  // z is free for the next rows
    }
  }
  cluster.sync();
  if (rank == 0) {
    for (int i = threadIdx.x; i < 2 * hu; i += blockDim.x) {
      (i < hu ? sum_out : sumsq_out)[a * hu + i % hu] = sum_over_ranks(cluster, acc + i);
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 reads its sums
}

// K3 alone: z_out [n, H*U] of the rows row_ids[0..n), kDrawTile rows per CTA, with K4's bits.
__global__ void __launch_bounds__(kDrawThreads)
draw_rows_kernel(const int* __restrict__ seed, const int* __restrict__ row_ids, int n,
                 int horizon, int dim_u, Features f, float* __restrict__ z_out) {
  extern __shared__ float4 smem4[];
  const int hu = horizon * dim_u;
  float* z = reinterpret_cast<float*>(smem4);  // [kDrawTile][H*U]
  float* g = z + kDrawTile * hu;               // [kDrawTile][n_cols] (colored)
  const float* basis = f.basis;
  if (f.basis_in_smem) {
    float* b = g + kDrawTile * f.n_cols;
    copy_to_shared(b, f.basis, f.two_f * horizon);
    basis = b;
  }
  const int i0 = blockIdx.x * kDrawTile;
  const int n_rows = min(kDrawTile, n - i0);
  draw_z_rows<kDrawTile>(
      z, g, basis, f, horizon, dim_u,
      [=](int r) { return static_cast<uint32_t>(row_ids[i0 + r]); }, n_rows, make_keys(seed));
  for (int i = threadIdx.x; i < n_rows * hu; i += blockDim.x) {
    z_out[(long long)i0 * hu + i] = z[i];
  }
}

// Scratch above which the kernels read the colored basis from global memory instead of a copy
// of their own.
constexpr size_t kBasisSmemLimit = 110 * 1024;

bool flagged(const Features& f) {
  return f.sampling != kWhite || f.extra != nullptr || f.clip != nullptr || f.gvec != nullptr;
}

bool valid(const Features& f, int horizon, int dim_u, int population) {
  if (f.sampling < kWhite || f.sampling > kColored) return false;
  if (f.sampling == kColored) {
    if (f.basis == nullptr || f.two_f != 2 * (horizon / 2 + 1) || f.n_cols != dim_u * f.two_f) {
      return false;
    }
  } else if (f.n_cols != horizon * dim_u) {
    return false;
  }
  if (f.extra != nullptr &&
      (f.extra_slots < 1 || f.population != population || f.extra_slots >= population)) {
    return false;
  }
  if (f.extra == nullptr && f.extra_slots != 0) return false;
  return true;
}

// Floats of shared memory the options add to `base_bytes`: the colored draw's [tile][n_cols]
// normals and, where it fits under kBasisSmemLimit, the basis (sets f->basis_in_smem).
size_t option_floats(Features* f, size_t base_bytes, int tile, int horizon) {
  if (f->sampling != kColored) return 0;
  size_t floats = (size_t)tile * f->n_cols;
  const size_t basis = (size_t)f->two_f * horizon;
  f->basis_in_smem = base_bytes + (floats + basis) * sizeof(float) <= kBasisSmemLimit;
  return floats + (f->basis_in_smem ? basis : 0);
}

// The arguments of K4/K5's entry points.
struct RolloutArgs {
  const float *s0, *mean, *std;
  const int *seed, *tile_member;
  int member_tile, agents;
  const float* stats;
  const void* weights;
  const float* biases;
  float *states_out, *actions_out;
  Problem p;
  int n_layers;
  const int* widths;
  int bf16, tile;
  cudaStream_t stream;
};

template <int T, typename W, bool kStreamed, bool kFlagged>
cudaError_t launch(const RolloutArgs& a, Features f, Occupancy* occ) {
  NetShape net;
  if (!make_shape<T, false>(a.n_layers, a.widths, a.p.ensemble, kIsBf16<W>, &net) ||
      a.p.rows % T || a.agents < 1 ||
      (a.tile_member && (a.member_tile <= 0 || a.member_tile % T))) {
    return cudaErrorInvalidValue;
  }
  const int n_ctas = a.tile_member ? 1 : min(a.p.ensemble, kMaxCluster);
  const int slots = head_slots(a.tile_member ? 1 : a.p.ensemble, n_ctas);
  size_t smem = step_bytes<T, W, false>(net, a.p.dim_s, slots).tail;
  if (!kStreamed) {
    // The prologue's scratch lies over the step's buffers.
    size_t scratch = sizeof(float) * draw_sub_tile(T) * a.p.horizon * a.p.dim_u;
    if (kFlagged) {
      scratch += option_floats(&f, scratch, draw_sub_tile(T), a.p.horizon) * sizeof(float);
    }
    if (scratch > smem) smem = scratch;
  }
  return launch_clusters(fused_rollout_kernel<T, W, kStreamed, kFlagged>, a.p.rows / T, n_ctas,
                         Cfg<T, W>::kThreads, smem, a.stream, occ, a.s0, a.mean, a.std, a.seed,
                         a.tile_member, a.member_tile, a.agents, a.stats,
                         static_cast<const W*>(a.weights), a.biases, a.states_out,
                         a.actions_out, a.p, net, f);
}

template <bool kStreamed, bool kFlagged>
cudaError_t fused_rollout(const RolloutArgs& a, const Features& f, Occupancy* occ) {
  // One tile per propagation, as in rollout.cu.
  if (a.tile_member != nullptr) {
    if (a.tile != kTileTs1) return cudaErrorInvalidValue;
    if (a.bf16) return launch<kTileTs1, __nv_bfloat16, kStreamed, kFlagged>(a, f, occ);
    return launch<kTileTs1, float, kStreamed, kFlagged>(a, f, occ);
  }
  if (a.tile != kTileMean) return cudaErrorInvalidValue;
  if (a.bf16) return launch<kTileMean, __nv_bfloat16, kStreamed, kFlagged>(a, f, occ);
  return launch<kTileMean, float, kStreamed, kFlagged>(a, f, occ);
}

cudaError_t fused_rollout_any(const RolloutArgs& a, const Features& f, bool streamed,
                              Occupancy* occ) {
  if (streamed) return fused_rollout<true, false>(a, f, occ);
  if (flagged(f)) return fused_rollout<false, true>(a, f, occ);
  return fused_rollout<false, false>(a, f, occ);
}

}  // namespace

extern "C" {

// K4. Draws the actions of `rows` rows (a multiple of `tile`; row = p * agents + a,
// agent-minor) from the counter RNG under `seed` [1] (int32, on the device) and the per-agent
// mean/std [agents, H*U], rolls them out from s0 [agents, S] for `horizon` steps, and writes the
// visited states [H, rows, S] and the actions it rolled out [H, rows, U]. `tile_member`
// [ceil(rows / member_tile)] gives each logical tile of `member_tile` rows (a multiple of
// `tile`) its member (ts1), or is NULL (mean). Weights, biases, stats, widths and `tile` are as
// in bbmpc_rollout_states.
// The options (each off at 0 / NULL): `sampling` 0 white normal, 1 uniform in (-1, 1), 2 colored
// through `basis` [two_f, H] with n_cols = U * two_f counters per row (otherwise n_cols = H*U);
// `extra` [extra_slots * agents, H*U] replaces the draws of population indices >= population -
// extra_slots; `clip` [2, U] clips the actions and writes the squared violation per row to
// `penalty_out` [rows]; `gvec` [agents, H*U] writes <gvec, action - mean> per row (std * z
// where nothing clipped or injected) to `dot_out` [rows]. Returns the launch's error, 0 for none.
int bbmpc_fused_rollout(const float* s0, const float* mean, const float* std, const int* seed,
                        const int* tile_member, int member_tile, const float* stats,
                        const void* weights, const float* biases, float* states_out,
                        float* actions_out, int horizon, int rows, int agents, int dim_s,
                        int dim_u, int stats_width, int ensemble, int n_layers,
                        const int* widths, int activation, int normalized, int predict_delta,
                        int bf16, int tile, int sampling, int n_cols, int two_f,
                        const float* basis, const float* extra, int extra_slots, int population,
                        const float* clip, const float* gvec, float* penalty_out, float* dot_out,
                        void* stream) {
  const Features f{sampling, n_cols,     two_f, 0,    basis,       extra,
                   extra_slots, population, clip,  gvec, penalty_out, dot_out};
  if (!valid(f, horizon, dim_u, population) || (clip != nullptr && penalty_out == nullptr) ||
      (gvec != nullptr && dot_out == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const RolloutArgs a{s0, mean, std, seed, tile_member, member_tile, agents, stats, weights,
                      biases, states_out, actions_out,
                      Problem{horizon, rows, dim_s, dim_u, stats_width, ensemble, activation,
                              normalized, predict_delta},
                      n_layers, widths, bf16, tile, static_cast<cudaStream_t>(stream)};
  return fused_rollout_any(a, f, false, nullptr);
}

// K5: the same function as K4 without options, generating step h's actions inside step h.
int bbmpc_fused_rollout_streamed(const float* s0, const float* mean, const float* std,
                                 const int* seed, const int* tile_member, int member_tile,
                                 const float* stats, const void* weights, const float* biases,
                                 float* states_out, float* actions_out, int horizon, int rows,
                                 int agents, int dim_s, int dim_u, int stats_width,
                                 int ensemble, int n_layers, const int* widths, int activation,
                                 int normalized, int predict_delta, int bf16, int tile,
                                 void* stream) {
  Features f{};
  f.n_cols = horizon * dim_u;
  const RolloutArgs a{s0, mean, std, seed, tile_member, member_tile, agents, stats, weights,
                      biases, states_out, actions_out,
                      Problem{horizon, rows, dim_s, dim_u, stats_width, ensemble, activation,
                              normalized, predict_delta},
                      n_layers, widths, bf16, tile, static_cast<cudaStream_t>(stream)};
  return fused_rollout_any(a, f, true, nullptr);
}

// What a launch of K4 (K5 with `streamed`) on `rows` rows would occupy, without launching;
// `out` is as in bbmpc_rollout_occupancy. `options` picks K4's instantiation with options, and
// `sampling`, `n_cols` and `two_f` size its scratch.
int bbmpc_fused_occupancy(int rows, int horizon, int dim_s, int dim_u, int ensemble,
                          int n_layers, const int* widths, int bf16, int ts1, int tile,
                          int streamed, int options, int sampling, int n_cols, int two_f,
                          int* out) {
  const int some_member = 0;
  const float some_bounds = 0.f;
  Features f{};
  f.sampling = sampling;
  f.n_cols = n_cols;
  f.two_f = two_f;
  if (options) f.clip = &some_bounds;  // any option: only tested against null here
  const RolloutArgs a{nullptr, nullptr, nullptr, nullptr, ts1 ? &some_member : nullptr, tile, 1,
                      nullptr, nullptr, nullptr, nullptr, nullptr,
                      Problem{horizon, rows, dim_s, dim_u, 1, ensemble, 0, 0, 0},
                      n_layers, widths, bf16, tile, nullptr};
  Occupancy occ{};
  const cudaError_t err = fused_rollout_any(a, f, streamed != 0, &occ);
  out[0] = occ.smem_bytes;
  out[1] = occ.blocks_per_sm;
  out[2] = occ.cluster;
  out[3] = occ.max_active_clusters;
  out[4] = occ.registers;
  out[5] = occ.local_bytes;
  out[6] = occ.threads;
  return err;
}

// K6. sum_out/sumsq_out [agents, H*U] = sum over the population of weight[row] * x and
// weight[row] * x^2, row = p * agents + a, weight [population * agents], where x is the
// centered sample: std[a] * z(row); with `clip` [2, U], clip(mean[a] + std[a] * z) - mean[a];
// on the last `extra_slots` population indices, extra - mean[a]. `sampling`, `n_cols`, `two_f`
// and `basis` are as in bbmpc_fused_rollout; `mean` may be NULL without clip and extra. One
// launch; rows of weight 0 are not drawn.
int bbmpc_elite_moments(const float* mean, const float* std, const float* weight,
                        const int* seed, float* sum_out, float* sumsq_out, int population,
                        int agents, int horizon, int dim_u, int sampling, int n_cols, int two_f,
                        const float* basis, const float* extra, int extra_slots,
                        const float* clip, void* stream) {
  if (population < 1 || agents < 1 || horizon < 1 || dim_u < 1) return cudaErrorInvalidValue;
  Features f{sampling, n_cols,     two_f, 0,       basis,   extra,
             extra_slots, population, clip,  nullptr, nullptr, nullptr};
  if (!valid(f, horizon, dim_u, population) ||
      ((clip != nullptr || extra != nullptr) && mean == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hu = horizon * dim_u;
  if (f.sampling == kColored) {
    size_t smem = sizeof(float) * (kMomentTile + 2) * hu;
    smem += option_floats(&f, smem, kMomentTile, horizon) * sizeof(float);
    return launch_clusters(moments_rows_kernel<kMomentTile>, agents, kMomentCluster,
                           kMomentThreads, smem, s, nullptr, mean, std, weight, seed, population,
                           agents, horizon, dim_u, f, sum_out, sumsq_out);
  }
  const int col_blocks = (hu + kMomentCols - 1) / kMomentCols;
  return launch_clusters(moments_cols_kernel, agents * col_blocks, kMomentCluster,
                         kMomentThreads, 0, s, nullptr, mean, std, weight, seed, population,
                         agents, horizon, dim_u, f, sum_out, sumsq_out);
}

// K3 alone. z_out [n, H*U] = the draws of the rows row_ids [n] (int32, row = p * agents + a)
// under `seed` [1], as K4 draws them: `sampling`, `n_cols`, `two_f` and `basis` as in
// bbmpc_fused_rollout.
int bbmpc_draw_rows(const int* seed, const int* row_ids, float* z_out, int n, int horizon,
                    int dim_u, int sampling, int n_cols, int two_f, const float* basis,
                    void* stream) {
  Features f{};
  f.sampling = sampling;
  f.n_cols = n_cols;
  f.two_f = two_f;
  f.basis = basis;
  if (n < 1 || horizon < 1 || dim_u < 1 || !valid(f, horizon, dim_u, 0)) {
    return cudaErrorInvalidValue;
  }
  size_t smem = sizeof(float) * kDrawTile * horizon * dim_u;
  smem += option_floats(&f, smem, kDrawTile, horizon) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(draw_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  draw_rows_kernel<<<(n + kDrawTile - 1) / kDrawTile, kDrawThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(seed, row_ids, n, horizon, dim_u, f,
                                                          z_out);
  return cudaGetLastError();
}

}  // extern "C"
