"""A recurrent state-space world model for planning: DreamerV3's RSSM (Hafner et al., *Mastering
Diverse Domains through World Models*, arXiv:2301.04104; ``danijar/dreamerv3``,
``dreamerv3/rssm.py``), planned through as PlaNet plans (arXiv:1811.04551, section 3).

The model's state is a feature ``feat = [h, z]``: a deterministic part ``h`` (``deter`` units)
and a stochastic part ``z``, ``stoch`` one-hot codes of ``classes`` classes each, flattened.
Every hidden layer is Linear, RMSNorm (a learned scale, eps ``norm_eps``), SiLU
(:func:`normed`); a head's last layer is a plain Linear.

* The core (the sequence model) steps ``h`` with the last ``z`` and action ``a``:
  ``x0, x1, x2`` = one hidden layer each of ``h``, ``z`` and ``a / max(1, |a|)``, ``hidden``
  wide; each of the ``blocks`` groups of ``h`` reads ``[h_g, x0, x1, x2]`` through
  block-diagonal linear layers (:func:`block_linear`; ``dyn_layers`` hidden layers, normed
  over all ``deter`` units together, then one to ``3 * deter``); the last gives each group its
  reset, candidate and update gates ``r, c, v``, and ``h' = s(v - 1) * tanh(s(r) * c) + (1 -
  s(v - 1)) * h`` with ``s`` the sigmoid (the GRU of ``rssm.py::_core``, its update biased by
  -1).
* The prior (imagination): ``img_layers`` hidden layers of ``h'``, then ``stoch * classes``
  logits; the posterior (the filter): ``obs_layers`` hidden layers of ``[h', e]``, then the
  logits; ``e`` is the encoder's, ``enc_layers`` hidden layers of ``units`` over
  ``symlog(obs)``. A code's probabilities are ``(1 - unimix) * softmax + unimix / classes``.
* A code is drawn from its probabilities by inverse CDF from a uniform (:func:`sample_codes`):
  the first class whose cumulative probability passes the uniform. That is the law of
  ``jax.random.categorical``, which DreamerV3 samples with, from ``stoch`` uniforms a row
  where the Gumbel-max trick takes ``stoch * classes``; the caller draws them.
* The reward head: ``reward_layers`` hidden layers of ``units`` over ``feat``, then
  ``num_bins`` logits, decoded by ``models/latent.py::two_hot_inv`` over ``linspace(vmin,
  vmax, num_bins)`` (the released code's ``TwoHot`` with ``symexp``).

Parameters are a dictionary of heads, each a list of layers ``{"w": [in, out], "b": [out]}``
with ``"scale"`` [out] on a normed layer: ``"encoder"``, ``"core_in"`` (the three input
layers, of ``h``, ``z`` and ``a``), ``"core_hidden"`` and ``"core_gru"`` (block layers: ``w``
[blocks, in, out] and ``b`` [blocks, out], per group; a hidden one's ``scale`` is [deter]),
``"prior"``, ``"posterior"`` and ``"reward"``.

:class:`RSSMWorldModel` holds the parameters for planning: what ``MPCPolicy`` reads of a
``DynamicsHandler``, with the filter step (:meth:`RSSMWorldModel.observe`) and the belief it
carries (:class:`Belief`) besides. It does not train.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from blackbox_mpc_torch.core.device import resolve_device
from blackbox_mpc_torch.models.latent import two_hot_inv
from blackbox_mpc_torch.models.mlp import linear
from blackbox_mpc_torch.ops import block_gemm
from blackbox_mpc_torch.utils.profiling import span

__all__ = ["Belief", "RSSMConfig", "RSSMWorldModel", "block_linear", "core", "encode",
           "init_params", "normed", "observe", "param_shapes", "posterior_probs", "prior_probs",
           "reward", "rms_norm", "sample_codes", "step", "symlog"]

# A truncated normal's std over that of the normal it is cut from, at +/-2 std: the factor
# by which a fan-in draw is widened to keep a variance of 1 / fan_in.
_TRUNCATED_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class RSSMConfig:
    """The sizes of an RSSM; the defaults are DreamerV3's ``size200m`` (``configs.yaml``:
    ``rssm: {deter: 8192, hidden: 1024, classes: 64}``, ``units: 1024``) with ``rssm.py``'s
    ``stoch: 32``, ``blocks: 8``, ``unimix: 0.01``, ``imglayers: 2``, ``obslayers: 1``,
    ``dynlayers: 1``, the encoder's three layers and the reward head's one layer and 255 bins.
    The model computes in float32."""

    obs_dim: int
    action_dim: int
    deter: int = 8192
    hidden: int = 1024
    stoch: int = 32
    classes: int = 64
    blocks: int = 8
    units: int = 1024
    enc_layers: int = 3
    img_layers: int = 2
    obs_layers: int = 1
    dyn_layers: int = 1
    reward_layers: int = 1
    num_bins: int = 255
    vmin: float = -20.0
    vmax: float = 20.0
    unimix: float = 0.01
    norm_eps: float = 1e-4

    def __post_init__(self):
        if self.deter % self.blocks:
            raise ValueError(f"deter ({self.deter}) must be a multiple of blocks "
                             f"({self.blocks})")
        if min(self.enc_layers, self.img_layers, self.obs_layers, self.dyn_layers,
               self.reward_layers) < 1:
            raise ValueError("every head and the core need at least one hidden layer")

    @property
    def codes(self) -> int:
        """The width of ``z``: ``stoch * classes``."""
        return self.stoch * self.classes

    @property
    def feat_dim(self) -> int:
        """The width of ``feat = [h, z]``."""
        return self.deter + self.codes


class Belief(NamedTuple):
    """What a policy carries from one ``act()`` to the next: the feature ``[h, z]`` [A,
    feat_dim] that the last call filtered and planned from, and the action [A, action_dim] it
    executed."""

    feat: torch.Tensor
    action: torch.Tensor


def _dense(fan_in: int, fan_out: int, normed_: bool = True) -> dict:
    layer = {"w": (fan_in, fan_out), "b": (fan_out,)}
    if normed_:
        layer["scale"] = (fan_out,)
    return layer


def _stack(first: int, hidden: int, layers: int, out: int | None = None) -> list:
    """``layers`` normed layers from ``first`` inputs, each ``hidden`` wide, then a plain one
    to ``out`` (None: none)."""
    stack = [_dense(first if i == 0 else hidden, hidden) for i in range(layers)]
    return stack if out is None else stack + [_dense(hidden, out, normed_=False)]


def param_shapes(config: RSSMConfig) -> dict:
    """The parameters' layout (the module's notes) with a shape in place of each tensor."""
    g, k, hid = config.blocks, config.deter // config.blocks, config.hidden
    return {
        "encoder": _stack(config.obs_dim, config.units, config.enc_layers),
        "core_in": [_dense(config.deter, hid), _dense(config.codes, hid),
                    _dense(config.action_dim, hid)],
        "core_hidden": [{"w": (g, k + 3 * hid if i == 0 else k, k), "b": (g, k),
                         "scale": (config.deter,)} for i in range(config.dyn_layers)],
        "core_gru": [{"w": (g, k, 3 * k), "b": (g, 3 * k)}],
        "prior": _stack(config.deter, hid, config.img_layers, config.codes),
        "posterior": _stack(config.deter + config.units, hid, config.obs_layers, config.codes),
        "reward": _stack(config.feat_dim, config.units, config.reward_layers, config.num_bins),
    }


def init_params(config: RSSMConfig, generator: torch.Generator) -> dict:
    """Seeded parameters on ``generator``'s device: every weight a normal truncated at two
    standard deviations (by inverse CDF), of variance 1 / fan_in after the cut, fan_in the
    layer's whole input (a block layer's groups counted together, as embodied's initializer
    counts a ``[blocks, in, out]`` kernel); zero biases; RMSNorm scales of 1. Unlike
    DreamerV3, the reward head's output is not zeroed (its ``outscale: 0`` ties every
    plan)."""
    device = generator.device

    def make(name, shape):
        if name == "w":
            fan_in = math.prod(shape[:-1])
            u = torch.rand(shape, generator=generator, device=device)
            z = math.sqrt(2.0) * torch.erfinv(math.erf(-math.sqrt(2.0))
                                               + 2.0 * math.erf(math.sqrt(2.0)) * u)
            return z.clamp_(-2.0, 2.0) * (1.0 / math.sqrt(fan_in) / _TRUNCATED_STD)
        return (torch.ones if name == "scale" else torch.zeros)(shape, device=device)

    return {head: [{name: make(name, shape) for name, shape in layer.items()}
                   for layer in layers] for head, layers in param_shapes(config).items()}


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``x / sqrt(mean(x^2) + eps) * scale`` over the last axis."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def normed(x: torch.Tensor, layer, eps: float) -> torch.Tensor:
    """``silu(rms_norm(x @ w + b))``: a hidden layer."""
    return F.silu(rms_norm(linear(x, layer), layer["scale"], eps))


def _head(layers, x: torch.Tensor, eps: float) -> torch.Tensor:
    for layer in layers[:-1]:
        x = normed(x, layer, eps)
    return linear(x, layers[-1])


def block_linear(x: torch.Tensor, layer) -> torch.Tensor:
    """The block-diagonal linear layer over ``x`` [blocks, B, in] (each group's rows): group
    ``i`` is ``x[i] @ w[i] + b[i]``, [blocks, B, out].

    On the CPU it is ``torch.baddbmm``. On CUDA it launches the tensor-core kernel
    (``ops/block_gemm.py::block_gemm``: split-operand 3xTF32, float32-accurate), which raises
    on what it cannot take, and adds one to ``block_linear.tensor_core_launches``."""
    if x.is_cuda:
        out = block_gemm.block_gemm(x, layer["w"], layer["b"])
        block_linear.tensor_core_launches += 1
        return out
    return torch.baddbmm(layer["b"][:, None, :], x, layer["w"])


block_linear.tensor_core_launches = 0


def core(config: RSSMConfig, params, h: torch.Tensor, z: torch.Tensor,
         a: torch.Tensor) -> torch.Tensor:
    """The sequence model: ``h`` [B, deter], ``z`` [B, codes], ``a`` [B, action_dim] -> the
    next ``h``. The groups are carried as [blocks, B, deter / blocks]."""
    eps, g, rows = config.norm_eps, config.blocks, h.shape[0]
    a = a.float()
    a = a / torch.clamp(torch.abs(a), min=1.0)
    x = torch.cat([normed(v, layer, eps) for v, layer in zip((h, z, a), params["core_in"])],
                  dim=-1)
    h_groups = h.reshape(rows, g, -1).transpose(0, 1)
    x = torch.cat([h_groups, x.expand(g, *x.shape)], dim=-1)
    for layer in params["core_hidden"]:
        x = block_linear(x, layer)
        # RMSNorm over the whole deter width: every group's units of a row together.
        x = x * torch.rsqrt(x.square().mean((0, 2), keepdim=True) + eps)
        x = F.silu(x * layer["scale"].view(g, 1, -1))
    r, c, v = block_linear(x, params["core_gru"][0]).chunk(3, dim=-1)
    update = torch.sigmoid(v - 1.0)
    h_groups = update * torch.tanh(torch.sigmoid(r) * c) + (1.0 - update) * h_groups
    return h_groups.transpose(0, 1).reshape(rows, -1)


def _code_probs(config: RSSMConfig, logits: torch.Tensor) -> torch.Tensor:
    """[B, codes] logits -> [B, stoch, classes] probabilities, mixed with the uniform."""
    probs = torch.softmax(logits.reshape(logits.shape[0], config.stoch, config.classes), -1)
    return (1.0 - config.unimix) * probs + config.unimix / config.classes


def prior_probs(config: RSSMConfig, params, h: torch.Tensor) -> torch.Tensor:
    """The prior's code probabilities at ``h``: [B, stoch, classes]."""
    return _code_probs(config, _head(params["prior"], h, config.norm_eps))


def posterior_probs(config: RSSMConfig, params, h: torch.Tensor,
                    e: torch.Tensor) -> torch.Tensor:
    """The posterior's code probabilities at ``h`` and the encoding ``e``: [B, stoch,
    classes]."""
    return _code_probs(config, _head(params["posterior"], torch.cat([h, e], -1),
                                     config.norm_eps))


def sample_codes(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One-hot codes [B, stoch * classes] drawn by inverse CDF: each code takes the first class
    whose cumulative probability passes its uniform ``u`` [B, stoch] (the last where rounding
    leaves the sum below it). Comparisons only: no value goes to the host."""
    classes = probs.shape[-1]
    index = (probs.cumsum(-1) <= u[..., None]).sum(-1).clamp_(max=classes - 1)
    one_hot = index[..., None] == torch.arange(classes, device=probs.device)
    return one_hot.to(probs.dtype).reshape(probs.shape[0], -1)


def encode(config: RSSMConfig, params, obs: torch.Tensor) -> torch.Tensor:
    """``obs`` [B, obs_dim] -> the encoding ``e`` [B, units]."""
    x = symlog(obs.float())
    for layer in params["encoder"]:
        x = normed(x, layer, config.norm_eps)
    return x


def step(config: RSSMConfig, params, feat: torch.Tensor, a: torch.Tensor,
         u: torch.Tensor | None = None) -> torch.Tensor:
    """One imagined step: ``feat`` [B, feat_dim], ``a`` [B, action_dim] -> the next feature,
    its codes drawn from the prior with the uniforms ``u`` [B, stoch]; with ``u`` None, the
    prior's probabilities in their place (the codes' expectation)."""
    h, z = feat.split([config.deter, config.codes], dim=-1)
    h = core(config, params, h, z, a)
    probs = prior_probs(config, params, h)
    z = probs.reshape(probs.shape[0], -1) if u is None else sample_codes(probs, u)
    return torch.cat([h, z], dim=-1)


def observe(config: RSSMConfig, params, feat: torch.Tensor, a: torch.Tensor, obs: torch.Tensor,
            u: torch.Tensor) -> torch.Tensor:
    """The filter step: the last feature ``feat`` and action ``a`` and the new observation
    ``obs`` -> the feature ``[h, z]`` with ``h`` the core's step and ``z`` drawn from the
    posterior with the uniforms ``u`` [B, stoch]."""
    h, z = feat.split([config.deter, config.codes], dim=-1)
    h = core(config, params, h, z, a)
    probs = posterior_probs(config, params, h, encode(config, params, obs))
    return torch.cat([h, sample_codes(probs, u)], dim=-1)


def reward(config: RSSMConfig, params, feat: torch.Tensor) -> torch.Tensor:
    """The reward head at ``feat``, decoded: [B]."""
    return two_hot_inv(_head(params["reward"], feat, config.norm_eps), config)


class RSSMWorldModel:
    """An RSSM held for planning, in the place of a ``DynamicsHandler``: it has the
    ``config``, ``dynamics_params``, ``dynamics_fn``, ``mean_dynamics_fn``, ``is_true_model``
    and ``device`` that ``MPCPolicy`` reads, and ``reward_fn``, the filter step ``observe``, the
    belief's start ``initial_belief`` and the rollout's draws ``code_draws`` besides. Pass
    ``reward_fn`` as the policy's reward function; the policy carries the belief.

    ``params``: the parameters to hold (the layout of the module's notes), on ``device``;
    None draws them with :func:`init_params` from ``seed``. ``observes`` counts the filter
    steps, ``belief_resets`` the beliefs set to DreamerV3's zeros.
    """

    is_true_model = False
    penalized_dynamics_fn = None

    def __init__(self, config: RSSMConfig, seed: int = 0, device=None, params=None):
        self._config = config
        self._device = resolve_device(device)
        if params is None:
            generator = torch.Generator(device=self._device)
            generator.manual_seed(seed)
            params = init_params(config, generator)
        self._params = params
        self.observes = 0
        self.belief_resets = 0

    @property
    def config(self) -> RSSMConfig:
        return self._config

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def dynamics_params(self) -> dict:
        return self._params

    def dynamics_fn(self, params, feat, a, noise=None) -> torch.Tensor:
        """The next feature: ``(params, feat, a[, noise]) -> feat'``, ``noise`` the codes'
        uniforms [B, stoch]; without it the prior's probabilities stand for the codes (the
        one-step prediction)."""
        return step(self._config, params, feat, a, noise)

    mean_dynamics_fn = dynamics_fn

    def reward_fn(self, feat, a, next_feat) -> torch.Tensor:
        """The decoded reward head at ``next_feat`` under the held parameters, in the policy's
        reward signature ``(s, a, s') -> [B]``: PlaNet scores a step by the reward predicted
        at the state it reaches."""
        del feat, a
        with span("models.reward"):
            return reward(self._config, self._params, next_feat)

    def initial_belief(self, agents: int) -> Belief:
        """DreamerV3's start of an episode: ``h``, ``z`` and the last action all zero."""
        self.belief_resets += 1
        zeros = lambda width: torch.zeros((agents, width), device=self._device)  # noqa: E731
        return Belief(zeros(self._config.feat_dim), zeros(self._config.action_dim))

    def observe(self, belief: Belief, obs: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        """The filter step from ``belief`` on ``obs`` [A, obs_dim], the posterior's codes drawn
        from ``generator``: the new feature [A, feat_dim]."""
        with span("models.observe"):
            self.observes += 1
            u = torch.rand((obs.shape[0], self._config.stoch), generator=generator,
                           device=self._device)
            return observe(self._config, self._params, belief.feat, belief.action, obs, u)

    def code_draws(self, generator: torch.Generator, horizon: int, rows: int) -> torch.Tensor:
        """One evaluation's uniforms for the prior's codes: [horizon, rows, stoch]."""
        return torch.rand((horizon, rows, self._config.stoch), generator=generator,
                          device=self._device)
