"""V-JEPA 2-AC's action-conditioned video world model, for planning toward a goal image (Assran
et al., "V-JEPA 2", arXiv:2506.09985, sections 3-4; facebookresearch/vjepa2: the encoder
``vit_giant_xformers`` of ``src/models/vision_transformer.py`` and the predictor
``vit_ac_predictor`` of ``src/models/ac_predictor.py``).

A frozen ViT encoder maps an image to a frame of patch latents, and a transformer predictor,
given the frames so far with an action and a proprioceptive state each, predicts the next
frame's latents. A plan's cost is the L1 distance of its last predicted frame to the goal
image's latents.

* Encoder: the image in [0, 1], normalised by ImageNet's mean and std and repeated over a
  ``tubelet_size``-frame tubelet, is cut into ``patches`` patches (``Conv3d`` with kernel =
  stride = ``(tubelet, patch, patch)``, computed here as one product over the flattened
  patches); ``enc_depth`` pre-norm blocks ``x += Proj(Attn(LN(x)))``, ``x += W2 GELU(W1
  LN(x))``; a final LayerNorm. The frame latent is that output normalised once more without an
  affine (the targets V-JEPA 2-AC trains on).
* Predictor, frame k: the tokens ``[a_k W_a, s_k W_s, z_k W_in]`` (two conditioning tokens,
  then the patches), ``pred_depth`` blocks of the same form under a block-causal mask (a token
  of frame k sees every token of the frames up to k), a LayerNorm and ``W_out`` on the patch
  tokens: the prediction of frame k + 1.
* Attention: ``qkv`` one product with bias, heads of ``dim / heads``, q and k turned by V-JEPA
  2's 3-D RoPE (:func:`rope_tables`), ``torch.nn.functional.scaled_dot_product_attention`` at
  scale ``1 / sqrt(head_dim)``. Every LayerNorm has eps ``ln_eps`` and an affine.
* Planning: the state integrates the actions (``s_{k+1} = s_k + a_k``, end-effector deltas),
  a candidate's value is ``-mean |z_H - z_goal|`` over the ``patches x enc_dim`` latents, and
  no step has a reward.

An imagined rollout carries the model's own state (:class:`Rollout`): the last frame's latents
and state, and a cache of the earlier frames' keys and values in every predictor block, which
frame k + 1 attends to with its own instead of running the earlier frames again. The cache is
written in place into one buffer per rollout shape (rows, horizon), held by the model for its
life, so that a CUDA graph of the evaluation replays it.

Parameters are a dictionary ``{"encoder": {...}, "predictor": {...}}`` (:func:`param_shapes`):
matrices ``[in, out]``, and the blocks' tensors stacked over the depth (``qkv_w`` [depth, dim,
3 dim]). The model computes in float32.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from blackbox_mpc_torch.core.device import per_device, resolve_device
from blackbox_mpc_torch.utils.profiling import span

__all__ = ["COND_TOKENS", "Rollout", "VJEPA2ACConfig", "VJEPA2ACWorldModel", "encode_images",
           "goal_energy", "init_params", "param_shapes", "patchify", "predict_frame",
           "rope_tables", "rotate"]

COND_TOKENS = 2  # a frame's action and state tokens, before its patches
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
ROPE_THETA = 10000.0
INIT_STD = 0.02


@dataclasses.dataclass(frozen=True)
class VJEPA2ACConfig:
    """The sizes of V-JEPA 2-AC; the defaults are the published ones: a ViT-g/16 encoder at
    256 x 256 (1408 wide, 40 blocks, 22 heads of 64, MLP 6144) and the ~300M predictor (1024
    wide, 24 blocks, 16 heads of 64, MLP 4096) over DROID's 7-D end-effector actions and
    states."""

    image_size: int = 256
    patch_size: int = 16
    tubelet_size: int = 2
    enc_dim: int = 1408
    enc_depth: int = 40
    enc_heads: int = 22
    enc_mlp_dim: int = 6144
    pred_dim: int = 1024
    pred_depth: int = 24
    pred_heads: int = 16
    pred_mlp_dim: int = 4096
    action_dim: int = 7
    state_dim: int = 7
    ln_eps: float = 1e-6
    latent_eps: float = 1e-5  # the frame latent's LayerNorm without an affine

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(f"image_size ({self.image_size}) must be a multiple of "
                             f"patch_size ({self.patch_size})")
        for dim, heads in ((self.enc_dim, self.enc_heads), (self.pred_dim, self.pred_heads)):
            if dim % heads or (dim // heads) // 3 < 2:
                raise ValueError(f"a width of {dim} over {heads} heads leaves no 3-D RoPE "
                                 "part: the head size must divide it and be at least 6")

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def patches(self) -> int:
        return self.grid ** 2

    @property
    def frame_tokens(self) -> int:
        return COND_TOKENS + self.patches

    @property
    def latent_size(self) -> int:
        """The floats of one frame's latents, ``patches x enc_dim``."""
        return self.patches * self.enc_dim

    @property
    def obs_dim(self) -> int:
        """An observation's floats: the image (channels, rows, columns in [0, 1]), then the
        state."""
        return 3 * self.image_size ** 2 + self.state_dim

    @property
    def dim_s(self) -> int:
        """A planning row's floats: a frame's latents, then the state."""
        return self.latent_size + self.state_dim


def _block_shapes(depth: int, dim: int, mlp: int) -> dict:
    return {"ln1_w": (depth, dim), "ln1_b": (depth, dim),
            "qkv_w": (depth, dim, 3 * dim), "qkv_b": (depth, 3 * dim),
            "proj_w": (depth, dim, dim), "proj_b": (depth, dim),
            "ln2_w": (depth, dim), "ln2_b": (depth, dim),
            "fc1_w": (depth, dim, mlp), "fc1_b": (depth, mlp),
            "fc2_w": (depth, mlp, dim), "fc2_b": (depth, dim)}


def param_shapes(config: VJEPA2ACConfig) -> dict:
    """The parameters' layout (the module's notes) with a shape in place of each tensor."""
    e, p = config.enc_dim, config.pred_dim
    patch_in = 3 * config.tubelet_size * config.patch_size ** 2
    return {
        "encoder": {"patch_w": (patch_in, e), "patch_b": (e,),
                    "blocks": _block_shapes(config.enc_depth, e, config.enc_mlp_dim),
                    "norm_w": (e,), "norm_b": (e,)},
        "predictor": {"action_w": (config.action_dim, p), "action_b": (p,),
                      "state_w": (config.state_dim, p), "state_b": (p,),
                      "embed_w": (e, p), "embed_b": (p,),
                      "blocks": _block_shapes(config.pred_depth, p, config.pred_mlp_dim),
                      "norm_w": (p,), "norm_b": (p,), "out_w": (p, e), "out_b": (e,)},
    }


def _is_norm_scale(name: str) -> bool:
    return name in ("ln1_w", "ln2_w", "norm_w")


def init_params(config: VJEPA2ACConfig, generator: torch.Generator) -> dict:
    """Seeded parameters on ``generator``'s device, the ViT family's init: every matrix from a
    normal of std 0.02 truncated at two standard deviations (drawn by inverse CDF), zero biases,
    LayerNorm at scale 1 and shift 0. Drawn in the order of sorted names, as
    ``tree_leaves`` walks them."""
    device = generator.device
    lo, hi = math.erf(-math.sqrt(2.0)), math.erf(math.sqrt(2.0))

    def make(name, shape):
        if _is_norm_scale(name):
            return torch.ones(shape, device=device)
        if name.endswith("_b"):
            return torch.zeros(shape, device=device)
        w = torch.rand(shape, generator=generator, device=device)
        w.mul_(hi - lo).add_(lo).erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        return w.mul_(INIT_STD)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else make(k, v)
                for k, v in sorted(tree.items())}

    return walk(param_shapes(config))


# --------------------------------------------------------------------------- the parts

def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` over the last axis, as one product over every leading row."""
    return torch.addmm(b, x.reshape(-1, x.shape[-1]), w).view(*x.shape[:-1], w.shape[-1])


@functools.lru_cache(maxsize=None)
def rope_tables(head_dim: int, positions: tuple, device: torch.device):
    """``(cos, sin)`` [N, head_dim] of the tokens at ``positions`` (N triples ``(t, h, w)``):
    V-JEPA 2's 3-D RoPE splits a head into a temporal, a height and a width part of ``2 *
    ((head_dim // 3) // 2)`` each, and leaves the rest as it is; in each part the pair ``(2i,
    2i + 1)`` turns by ``pos * theta^(-2i / part)``. Made once per device and positions."""
    part = 2 * ((head_dim // 3) // 2)
    pos = torch.tensor(positions, dtype=torch.float32).reshape(-1, 3)
    omega = ROPE_THETA ** (-torch.arange(part // 2, dtype=torch.float32) / (part / 2.0))
    angles = [(pos[:, axis, None] * omega).repeat_interleave(2, dim=-1) for axis in range(3)]
    rest = head_dim - 3 * part
    cos = torch.cat([*(a.cos() for a in angles), torch.ones(len(pos), rest)], dim=-1)
    sin = torch.cat([*(a.sin() for a in angles), torch.zeros(len(pos), rest)], dim=-1)
    return cos.to(device), sin.to(device)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x`` [..., N, head_dim] with each pair ``(2i, 2i + 1)`` turned by its angle."""
    pairs = x.unflatten(-1, (-1, 2))
    turned = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)
    return x * cos + turned * sin


def _encoder_positions(config: VJEPA2ACConfig) -> tuple:
    g = config.grid
    return tuple((0, i, j) for i in range(g) for j in range(g))


def _frame_positions(config: VJEPA2ACConfig, frame: int) -> tuple:
    """Frame ``frame``'s tokens: the action and state tokens at the frame's time alone
    (``(frame, 0, 0)``: the height and width parts unturned), the patches at ``(frame, i,
    j)``."""
    g = config.grid
    return ((frame, 0, 0),) * COND_TOKENS + tuple((frame, i, j) for i in range(g)
                                                  for j in range(g))


def attention(q, k, v, mask=None) -> torch.Tensor:
    """``softmax(q k^T / sqrt(head_dim) + mask) v`` over [B, heads, N, head_dim]; ``mask``: a
    boolean [N, M], True where a query may attend to a key."""
    with span("models.attend"):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def _block(x, blocks: dict, i: int, heads: int, rope, eps: float, past=None, mask=None):
    """Block ``i`` of a stack over ``x`` [B, N, D]: ``(x', k, v)``, with ``k`` (turned) and
    ``v`` [B, heads, N, head_dim] the block's keys and values of ``x``'s tokens. ``past``: the
    keys and values of earlier tokens, which ``x``'s tokens attend to before their own."""
    b, n, d = x.shape
    h = F.layer_norm(x, (d,), blocks["ln1_w"][i], blocks["ln1_b"][i], eps)
    qkv = _dense(h, blocks["qkv_w"][i], blocks["qkv_b"][i])
    q, k, v = qkv.view(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    q, k = rotate(q, *rope), rotate(k, *rope)
    keys, values = (k, v) if past is None else (torch.cat([past[0], k], dim=2),
                                                torch.cat([past[1], v], dim=2))
    o = attention(q, keys, values, mask).transpose(1, 2).reshape(b, n, d)
    x = x + _dense(o, blocks["proj_w"][i], blocks["proj_b"][i])
    h = F.layer_norm(x, (d,), blocks["ln2_w"][i], blocks["ln2_b"][i], eps)
    h = F.gelu(_dense(h, blocks["fc1_w"][i], blocks["fc1_b"][i]))
    return x + _dense(h, blocks["fc2_w"][i], blocks["fc2_b"][i]), k, v


_IMAGENET = per_device(lambda device: tuple(
    torch.tensor(c, device=device).view(3, 1, 1) for c in (IMAGENET_MEAN, IMAGENET_STD)))


def patchify(config: VJEPA2ACConfig, images: torch.Tensor) -> torch.Tensor:
    """``images`` [B, 3, H, W], each repeated over a tubelet -> [B, patches, 3 x tubelet x
    patch x patch], each patch in ``Conv3d``'s weight order (channel, time, row, column)."""
    b, g, p, t = images.shape[0], config.grid, config.patch_size, config.tubelet_size
    x = images.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)  # [B, g, g, 3, p, p]
    return x.unsqueeze(4).expand(b, g, g, 3, t, p, p).reshape(b, g * g, 3 * t * p * p)


def encode_images(config: VJEPA2ACConfig, params, images: torch.Tensor) -> torch.Tensor:
    """``images`` [B, 3, H, W] in [0, 1] -> frame latents [B, patches, enc_dim]."""
    enc = params["encoder"]
    mean, std = _IMAGENET(images.device)
    x = _dense(patchify(config, (images.float() - mean) / std), enc["patch_w"], enc["patch_b"])
    d = config.enc_dim
    rope = rope_tables(d // config.enc_heads, _encoder_positions(config), images.device)
    for i in range(config.enc_depth):
        x = _block(x, enc["blocks"], i, config.enc_heads, rope, config.ln_eps)[0]
    x = F.layer_norm(x, (d,), enc["norm_w"], enc["norm_b"], config.ln_eps)
    return F.layer_norm(x, (d,), eps=config.latent_eps)


def _frame_tokens(config: VJEPA2ACConfig, pred: dict, z, s, a) -> torch.Tensor:
    """``[a W_a, s W_s, z W_in]``: [B, frame_tokens, pred_dim] of ``z`` [B, patches, enc_dim],
    ``s`` [B, state_dim], ``a`` [B, action_dim]."""
    return torch.cat([_dense(a.float(), pred["action_w"], pred["action_b"])[:, None],
                      _dense(s, pred["state_w"], pred["state_b"])[:, None],
                      _dense(z, pred["embed_w"], pred["embed_b"])], dim=1)


def _readout(config: VJEPA2ACConfig, pred: dict, x: torch.Tensor) -> torch.Tensor:
    """The predictor's patch tokens of ``x`` [..., frame_tokens, pred_dim] -> the predicted
    latents [..., patches, enc_dim]."""
    x = F.layer_norm(x[..., COND_TOKENS:, :], (config.pred_dim,), pred["norm_w"],
                     pred["norm_b"], config.ln_eps)
    return _dense(x, pred["out_w"], pred["out_b"])


def predict_frame(config: VJEPA2ACConfig, params, z, s, a, frame: int = 0,
                  cache: torch.Tensor | None = None) -> torch.Tensor:
    """One imagined frame: frame ``frame``'s latents ``z`` [B, patches, enc_dim], state ``s``
    and action ``a`` -> the next frame's latents. Each block attends to the cached keys and
    values of the frames before ``frame`` (``cache`` [depth, 2, B, heads, slots x
    frame_tokens, head_dim]; none at frame 0), and writes the frame's own into the cache where
    it has a slot for them."""
    pred, heads, t = params["predictor"], config.pred_heads, config.frame_tokens
    rope = rope_tables(config.pred_dim // heads, _frame_positions(config, frame), z.device)
    store = cache is not None and (frame + 1) * t <= cache.shape[4]
    x = _frame_tokens(config, pred, z, s, a)
    for i in range(config.pred_depth):
        past = None if frame == 0 else (cache[i, 0, :, :, :frame * t],
                                        cache[i, 1, :, :, :frame * t])
        x, k, v = _block(x, pred["blocks"], i, heads, rope, config.ln_eps, past)
        if store:
            cache[i, 0, :, :, frame * t:(frame + 1) * t].copy_(k)
            cache[i, 1, :, :, frame * t:(frame + 1) * t].copy_(v)
    return _readout(config, pred, x)


def goal_energy(z: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
    """The L1 energy ``mean |z - goal|`` over each row's latents: ``z`` [B, patches, enc_dim],
    ``goal`` [patches, enc_dim] -> [B]."""
    return (z - goal).abs().mean(dim=(-2, -1))


# --------------------------------------------------------------------------- planning

class Rollout(NamedTuple):
    """An imagined rollout's state, the model's own: the last frame's latents ``z`` [B,
    patches, enc_dim] (encoded or predicted), its state ``s`` [B, state_dim], the frame's index
    and the keys and values of the frames before it (:func:`predict_frame`'s ``cache``; None
    where the rollout is one frame long)."""

    z: torch.Tensor
    s: torch.Tensor
    frame: int
    cache: torch.Tensor | None


class VJEPA2ACWorldModel:
    """V-JEPA 2-AC held for planning toward a goal image, in the place of a
    ``DynamicsHandler``: it has the ``config``, ``dynamics_params``, ``dynamics_fn``,
    ``mean_dynamics_fn``, ``is_true_model`` and ``device`` that ``MPCPolicy`` reads, and
    ``encode``, ``reward_fn`` (no reward a step), ``terminal_value`` (minus the goal energy),
    ``value_inputs`` (the goal), ``begin_rollout`` (a rollout's own state) and ``set_goal``
    besides. Pass ``reward_fn`` as the policy's reward function, and set a goal before the
    first ``act()`` of each episode.

    An observation is one flat row per agent: the image (3 x image_size x image_size, channels
    first, in [0, 1]) and then the state. ``encode`` turns it into a planning row, the frame's
    latents and the state (``config.dim_s`` floats); the one-step prediction is such a row.

    ``params``: the parameters to hold (the layout of the module's notes), on ``device``; None
    draws them with :func:`init_params` from ``seed``. Counters: ``encodes`` (observations),
    ``goal_encodes``, ``predicted_frames`` (each frame predicted eagerly or captured: a
    replayed CUDA graph predicts without calling the model) and ``kv_cache_bytes`` (the
    cache of the last rollout begun).
    """

    is_true_model = False
    penalized_dynamics_fn = None

    def __init__(self, config: VJEPA2ACConfig | None = None, seed: int = 0, device=None,
                 params=None):
        self._config = VJEPA2ACConfig() if config is None else config
        self._device = resolve_device(device)
        if params is None:
            generator = torch.Generator(device=self._device)
            generator.manual_seed(seed)
            params = init_params(self._config, generator)
        self._params = params
        self._goal = None
        # (rows, horizon) -> the cache of a rollout of that shape, kept while the model lives:
        # a CUDA graph captured over it writes into it at every replay.
        self._caches = {}
        self.encodes = 0
        self.goal_encodes = 0
        self.predicted_frames = 0
        self.kv_cache_bytes = 0

    @property
    def config(self) -> VJEPA2ACConfig:
        return self._config

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def dynamics_params(self) -> dict:
        return self._params

    @property
    def goal(self) -> torch.Tensor | None:
        """The goal image's latents [patches, enc_dim] on the device, or None before
        ``set_goal``."""
        return self._goal

    def _split(self, rows: torch.Tensor):
        c = self._config
        return rows[:, :c.latent_size].view(-1, c.patches, c.enc_dim), rows[:, c.latent_size:]

    def encode(self, obs: torch.Tensor) -> torch.Tensor:
        """Observations [A, obs_dim] -> planning rows [A, dim_s]: the image's latents, then the
        state."""
        c = self._config
        with span("models.encode"):
            self.encodes += 1
            image, state = obs.float().split([c.obs_dim - c.state_dim, c.state_dim], dim=-1)
            image = image.reshape(-1, 3, c.image_size, c.image_size)
            z = encode_images(c, self._params, image)
            return torch.cat([z.flatten(1), state], dim=-1)

    def set_goal(self, image) -> None:
        """Encodes the goal image (3 x image_size x image_size floats in [0, 1], channels first;
        numpy or a tensor) and keeps its latents on the device until the next goal."""
        c = self._config
        with span("models.goal"):
            self.goal_encodes += 1
            x = torch.as_tensor(image, dtype=torch.float32, device=self._device)
            x = x.reshape(1, 3, c.image_size, c.image_size)
            self._goal = encode_images(c, self._params, x)[0]

    def value_inputs(self, generator: torch.Generator, rows: int) -> tuple:
        """An evaluation's inputs of the terminal value: the goal's latents. Nothing is
        drawn."""
        del generator, rows
        if self._goal is None:
            raise RuntimeError("VJEPA2ACWorldModel plans toward a goal: call set_goal(image) "
                               "before planning")
        return (self._goal,)

    def begin_rollout(self, rows: torch.Tensor, horizon: int) -> Rollout:
        """The state of a rollout of ``horizon`` frames from the planning rows ``rows`` [B,
        dim_s], with the cache of its shape (made at the shape's first rollout)."""
        c, cache = self._config, None
        if horizon > 1:
            key = (rows.shape[0], horizon)
            cache = self._caches.get(key)
            if cache is None:
                cache = self._caches[key] = torch.empty(
                    (c.pred_depth, 2, rows.shape[0], c.pred_heads,
                     (horizon - 1) * c.frame_tokens, c.pred_dim // c.pred_heads),
                    device=rows.device)
        self.kv_cache_bytes = 0 if cache is None else cache.nbytes
        z, s = self._split(rows)
        return Rollout(z, s, 0, cache)

    def rollout_buffer_bytes(self) -> int:
        """The bytes of every rollout cache the model holds."""
        return sum(cache.nbytes for cache in self._caches.values())

    def dynamics_fn(self, params, state, a, noise=None):
        """The next frame: a :class:`Rollout` to the next (the cache read and written), or a
        planning row [B, dim_s] to the next row (frame 0 alone: the one-step prediction). The
        model is deterministic and reads no noise."""
        del noise
        with span("models.predict"):
            self.predicted_frames += 1
            if isinstance(state, Rollout):
                z = predict_frame(self._config, params, state.z, state.s, a, state.frame,
                                  state.cache)
                return Rollout(z, state.s + a, state.frame + 1, state.cache)
            z, s = self._split(state)
            z = predict_frame(self._config, params, z, s, a)
            return torch.cat([z.flatten(1), s + a], dim=-1)

    mean_dynamics_fn = dynamics_fn

    def reward_fn(self, state, a, next_state) -> torch.Tensor:
        """No reward a step: zeros [B]. The plan's value is the terminal value alone."""
        del state, next_state
        return a.new_zeros(a.shape[0])

    def terminal_value(self, params, state, goal) -> torch.Tensor:
        """Minus the goal energy of the rollout's last frame (a :class:`Rollout` or planning
        rows): [B]."""
        del params
        with span("models.value"):
            z = state.z if isinstance(state, Rollout) else self._split(state)[0]
            return -goal_energy(z, goal)
