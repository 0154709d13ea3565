"""A latent world model for planning: TD-MPC2's (Hansen, Su and Wang, ICLR 2024,
arXiv:2310.16828; ``tdmpc2/common/world_model.py``, ``layers.py`` and ``math.py``).

The observation is encoded once into a latent ``z``, and planning runs in that latent space:
the dynamics head predicts the next latent, the reward head the reward, and a policy prior
``pi`` with ``num_q`` Q heads give the value of the state a plan ends in. Every hidden layer is
``normed_linear`` (``models/mlp.py``: Linear, LayerNorm, Mish), and the last layer of a head is
a plain Linear; the encoder and the dynamics end in Linear, LayerNorm and SimNorm:

* encoder: ``[obs, task]`` -> ``num_enc_layers - 1`` layers of ``enc_dim`` -> ``latent_dim``;
* dynamics: ``[z, task, a]`` -> 2 layers of ``mlp_dim`` -> ``latent_dim``;
* reward, each Q head: ``[z, task, a]`` -> 2 layers of ``mlp_dim`` -> ``num_bins`` logits,
  read by the two-hot decode ``symexp(sum(softmax(x) * linspace(vmin, vmax, num_bins)))``;
* ``pi``: ``[z, task]`` -> 2 layers of ``mlp_dim`` -> ``mean``, ``log_std`` (each
  ``action_dim``); ``log_std`` is squashed into ``[log_std_min, log_std_max]`` by
  ``low + (high - low) * (tanh(x) + 1) / 2`` and the action is ``tanh(mean + eps *
  exp(log_std))``.

SimNorm is a softmax over each group of ``simnorm_dim`` latent units. ``task`` is the one row of
the task embedding the model plans for (``task_dim`` 0: none). The value of a latent is
``(Q_i + Q_j)(z, pi(z)) / 2`` over a pair ``(i, j)`` of the Q heads, TD-MPC2's
``Q(..., return_type="avg")``; the pair and ``pi``'s ``eps`` are arguments, so the caller draws
them (:func:`value_draws`).

Parameters are a dictionary: ``"task"`` [task_dim] (without ``task_dim``, absent) and, per
head (``"encoder"``, ``"dynamics"``, ``"reward"``, ``"pi"``, ``"q"``), a list of layers
``{"w": [in, out], "b": [out]}`` with ``"ln_w"``, ``"ln_b"`` [out] on a normed layer. The Q
heads' tensors carry a leading ``[num_q]`` axis.

:class:`LatentWorldModel` holds the parameters for planning: what ``MPCPolicy`` reads of a
``DynamicsHandler``, and the encoder, the decoded reward and the terminal value besides. It
does not train.
"""
from __future__ import annotations

import dataclasses

import torch

from blackbox_mpc_torch.core.device import resolve_device
from blackbox_mpc_torch.models.mlp import linear, normed_linear
from blackbox_mpc_torch.utils.profiling import span

__all__ = ["HEADS", "LatentModelConfig", "LatentWorldModel", "encode", "init_params",
           "next_latent", "param_shapes", "pi", "q_values", "reward", "simnorm",
           "terminal_value", "two_hot_inv", "value_draws"]

HEADS = ("encoder", "dynamics", "reward", "pi", "q")


@dataclasses.dataclass(frozen=True)
class LatentModelConfig:
    """The sizes of a TD-MPC2 world model; the defaults are ``tdmpc2/config.yaml``'s and its
    ``MODEL_SIZE[5]``. The model computes in float32."""

    obs_dim: int
    action_dim: int
    latent_dim: int = 512
    enc_dim: int = 256
    mlp_dim: int = 512
    num_enc_layers: int = 2
    num_q: int = 5
    simnorm_dim: int = 8
    num_bins: int = 101
    vmin: float = -10.0
    vmax: float = 10.0
    task_dim: int = 96
    log_std_min: float = -10.0
    log_std_max: float = 2.0

    def __post_init__(self):
        if self.latent_dim % self.simnorm_dim:
            raise ValueError(f"latent_dim ({self.latent_dim}) must be a multiple of "
                             f"simnorm_dim ({self.simnorm_dim})")
        if self.num_q < 2:
            raise ValueError(f"the value averages two Q heads: num_q must be >= 2, got "
                             f"{self.num_q}")
        if self.num_bins < 2:
            raise ValueError(f"the two-hot decode needs num_bins >= 2, got {self.num_bins}")

    def layer_sizes(self) -> dict:
        """``{head: [in, hidden..., out]}``."""
        z, t, a, m = self.latent_dim, self.task_dim, self.action_dim, self.mlp_dim
        encoder = [self.obs_dim + t, *[self.enc_dim] * max(self.num_enc_layers - 1, 1), z]
        return {"encoder": encoder, "dynamics": [z + t + a, m, m, z],
                "reward": [z + t + a, m, m, self.num_bins], "pi": [z + t, m, m, 2 * a],
                "q": [z + t + a, m, m, self.num_bins]}

    def normed_last(self, head: str) -> bool:
        """Whether ``head``'s last layer is normed (and SimNorm follows): the latent's."""
        return head in ("encoder", "dynamics")


def param_shapes(config: LatentModelConfig) -> dict:
    """The parameters' layout (the module's notes) with a shape in place of each tensor."""
    shapes = {}
    for head, sizes in config.layer_sizes().items():
        lead = (config.num_q,) if head == "q" else ()
        layers = []
        for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            layer = {"w": (*lead, fan_in, fan_out), "b": (*lead, fan_out)}
            if i < len(sizes) - 2 or config.normed_last(head):
                layer["ln_w"] = layer["ln_b"] = (*lead, fan_out)
            layers.append(layer)
        shapes[head] = layers
    if config.task_dim:
        shapes["task"] = (config.task_dim,)
    return shapes


def init_params(config: LatentModelConfig, generator: torch.Generator) -> dict:
    """Seeded parameters on ``generator``'s device, TD-MPC2's ``weight_init``: every Linear's
    weight from a normal of std 0.02 truncated at +/-2 (``torch.nn.init.trunc_normal_``'s
    absolute bounds), zero biases, LayerNorm at scale 1 and shift 0, and the task row uniform
    in +/-0.02. Unlike TD-MPC2, the reward and Q heads' last layers are not zeroed: on zero
    heads every plan's return is equal."""
    device = generator.device

    def make(name, shape):
        if name == "w":
            w = torch.randn(shape, generator=generator, device=device)
            return (w * 0.02).clamp_(-2.0, 2.0)
        return (torch.ones if name == "ln_w" else torch.zeros)(shape, device=device)

    shapes = param_shapes(config)
    params = {head: [{name: make(name, shape) for name, shape in layer.items()}
                     for layer in shapes[head]] for head in HEADS}
    if config.task_dim:
        u = torch.rand(config.task_dim, generator=generator, device=device)
        params["task"] = (2.0 * u - 1.0) * 0.02
    return params


def simnorm(x: torch.Tensor, group: int) -> torch.Tensor:
    """A softmax over each group of ``group`` units of the last axis."""
    shape = x.shape
    return torch.softmax(x.reshape(*shape[:-1], -1, group), dim=-1).reshape(shape)


def two_hot_inv(logits: torch.Tensor, config) -> torch.Tensor:
    """``[..., num_bins]`` logits -> ``[...]``: ``symexp`` of the softmax's expectation over
    ``linspace(vmin, vmax, num_bins)``. ``config``: the bin range, any object with ``vmin``
    and ``vmax`` (a ``LatentModelConfig``, an ``RSSMConfig``)."""
    bins = torch.linspace(config.vmin, config.vmax, logits.shape[-1], device=logits.device,
                          dtype=logits.dtype)
    x = torch.sum(torch.softmax(logits, dim=-1) * bins, dim=-1)
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def _with_task(params, x: torch.Tensor) -> torch.Tensor:
    """``[x, task]``, the task row tiled over the rows (TD-MPC2's ``task_emb``)."""
    task = params.get("task")
    if task is None:
        return x
    return torch.cat([x, task.expand(*x.shape[:-1], task.shape[-1])], dim=-1)


def _head(params, head: str, x: torch.Tensor, config: LatentModelConfig) -> torch.Tensor:
    layers = params[head]
    for layer in layers[:-1]:
        x = normed_linear(x, layer, "mish")
    if config.normed_last(head):
        return simnorm(normed_linear(x, layers[-1], None), config.simnorm_dim)
    return linear(x, layers[-1])


def encode(config: LatentModelConfig, params, obs: torch.Tensor) -> torch.Tensor:
    """``obs`` [B, obs_dim] -> ``z`` [B, latent_dim]."""
    return _head(params, "encoder", _with_task(params, obs.float()), config)


def next_latent(config: LatentModelConfig, params, z: torch.Tensor,
                a: torch.Tensor) -> torch.Tensor:
    """The dynamics head: ``z`` [B, latent_dim], ``a`` [B, action_dim] -> the next latent."""
    return _head(params, "dynamics", torch.cat([_with_task(params, z), a.float()], -1),
                 config)


def reward(config: LatentModelConfig, params, z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The reward head, decoded: [B]."""
    x = torch.cat([_with_task(params, z), a.float()], -1)
    return two_hot_inv(_head(params, "reward", x, config), config)


def pi(config: LatentModelConfig, params, z: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """The policy prior's action at ``z`` for the standard normals ``eps`` [B, action_dim]."""
    mean, raw = _head(params, "pi", _with_task(params, z), config).chunk(2, dim=-1)
    low, high = config.log_std_min, config.log_std_max
    log_std = low + 0.5 * (high - low) * (torch.tanh(raw) + 1.0)
    return torch.tanh(mean + eps * torch.exp(log_std))


def q_values(config: LatentModelConfig, params, z: torch.Tensor, a: torch.Tensor,
             heads: torch.Tensor) -> torch.Tensor:
    """The Q heads ``heads`` ([n] indices) at ``(z, a)``, decoded: [n, B]."""
    layers = [{k: v.index_select(0, heads) for k, v in layer.items()} for layer in params["q"]]
    x = torch.cat([_with_task(params, z), a.float()], -1)
    return two_hot_inv(_head({"q": layers}, "q", x, config), config)


def terminal_value(config: LatentModelConfig, params, z: torch.Tensor, eps: torch.Tensor,
                   pair: torch.Tensor) -> torch.Tensor:
    """The value of ``z`` [B, latent_dim]: the mean of the Q heads ``pair`` ([2] indices) at
    ``(z, pi(z, eps))``, [B]."""
    return q_values(config, params, z, pi(config, params, z, eps), pair).mean(0)


def value_draws(generator: torch.Generator, rows: int, config: LatentModelConfig, device):
    """The draws of one evaluation's terminal value: ``pi``'s ``eps`` [rows, action_dim]
    (``torch.randn``) and a pair of distinct Q heads, ``torch.rand(num_q).argsort()[:2]``
    (the law of TD-MPC2's ``randperm(num_q)[:2]``). Their shapes depend on no data, and
    nothing is read back to the host."""
    eps = torch.randn((rows, config.action_dim), generator=generator, device=device)
    pair = torch.rand(config.num_q, generator=generator, device=device).argsort()[:2]
    return eps, pair


class LatentWorldModel:
    """A latent world model held for planning, in the place of a ``DynamicsHandler``: it has
    the ``config``, ``dynamics_params``, ``dynamics_fn``, ``mean_dynamics_fn``,
    ``is_true_model`` and ``device`` that ``MPCPolicy`` reads, and ``encode``, ``reward_fn``,
    ``terminal_value`` and its draws ``value_inputs`` besides. Pass ``reward_fn`` as the
    policy's reward function.

    ``params``: the parameters to hold (the layout of the module's notes), on ``device``;
    None draws them with :func:`init_params` from ``seed``. ``encodes`` and ``value_calls``
    count the calls of ``encode`` and ``terminal_value``: eager work, which a replayed CUDA
    graph does without calling either.
    """

    is_true_model = False
    penalized_dynamics_fn = None

    def __init__(self, config: LatentModelConfig, seed: int = 0, device=None, params=None):
        self._config = config
        self._device = resolve_device(device)
        if params is None:
            generator = torch.Generator(device=self._device)
            generator.manual_seed(seed)
            params = init_params(config, generator)
        self._params = params
        self.encodes = 0
        self.value_calls = 0

    @property
    def config(self) -> LatentModelConfig:
        return self._config

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def dynamics_params(self) -> dict:
        return self._params

    def dynamics_fn(self, params, z, a, noise=None) -> torch.Tensor:
        """The next latent: ``(params, z, a[, noise]) -> z'``; the model is deterministic and
        reads no noise."""
        del noise
        return next_latent(self._config, params, z, a)

    mean_dynamics_fn = dynamics_fn

    def reward_fn(self, z, a, next_z) -> torch.Tensor:
        """The decoded reward head at ``(z, a)`` under the held parameters, in the policy's
        reward signature ``(s, a, s') -> [B]``."""
        del next_z
        with span("models.reward"):
            return reward(self._config, self._params, z, a)

    def encode(self, obs: torch.Tensor) -> torch.Tensor:
        with span("models.encode"):
            self.encodes += 1
            return encode(self._config, self._params, obs)

    def value_inputs(self, generator: torch.Generator, rows: int) -> tuple:
        """An evaluation's draws of the terminal value over ``rows`` rows
        (:func:`value_draws`)."""
        return value_draws(generator, rows, self._config, self._device)

    def terminal_value(self, params, z, eps, pair) -> torch.Tensor:
        with span("models.value"):
            self.value_calls += 1
            return terminal_value(self._config, params, z, eps, pair)
