"""TD-MPC2's world model written out plainly, in float32 PyTorch, for the tests of
``blackbox_mpc_torch/models/latent.py``. It imports nothing of that package (nor JAX).

Written from Hansen, Su and Wang, *TD-MPC2: Scalable, Robust World Models for Continuous
Control*, ICLR 2024 (arXiv:2310.16828), and its code (github.com/nicklashansen/tdmpc2):
``common/world_model.py`` (``encode``, ``next``, ``reward``, ``pi``, ``Q``), ``common/layers.py``
(``NormedLinear``: Linear, LayerNorm, Mish; ``SimNorm``; ``mlp``), ``common/math.py``
(``two_hot_inv``, ``symexp``, ``log_std``, ``squash``) and ``tdmpc2.py::_estimate_value``.

* Every hidden layer is Linear, LayerNorm (eps 1e-5, with scale and shift), Mish; a head's last
  layer is a plain Linear, except the encoder's and the dynamics', which are Linear, LayerNorm,
  SimNorm (a softmax over each group of ``simnorm_dim`` units).
* The task row is appended to the latent (or the observation) before the action, as
  ``task_emb`` appends it: the heads read ``[z, task, a]``.
* The reward and each Q head give ``num_bins`` logits, decoded as ``symexp`` of the softmax's
  expectation over ``linspace(vmin, vmax, num_bins)``.
* ``pi``: ``mean, x = chunk(out, 2)``, ``log_std = low + (high - low) * (tanh(x) + 1) / 2``,
  the action ``tanh(mean + eps * exp(log_std))``.
* A plan's value from ``z_0``: ``sum_{t<H} gamma^t r(z_t, a_t) + gamma^H * (Q_i + Q_j)(z_H,
  pi(z_H)) / 2`` with ``z_{t+1} = next(z_t, a_t)``, the discount carried by repeated
  multiplication.

Departures, each the caller's to make: ``pi``'s normals and the pair ``(i, j)`` are arguments
(TD-MPC2 draws them inside ``pi`` and ``Q``); dropout is off (TD-MPC2's planning runs the
model in eval mode); the action mask of multitask sets is absent (every action dimension is
the task's).

Parameters: a dictionary, ``"task"`` [task_dim] (absent without a task) and per head
(``"encoder"``, ``"dynamics"``, ``"reward"``, ``"pi"``, ``"q"``) a list of layers ``{"w": [in,
out], "b": [out]}`` with ``"ln_w"``, ``"ln_b"`` on a normed layer; the Q heads' tensors carry a
leading ``[num_q]`` axis. ``config``: a mapping with ``simnorm_dim``, ``num_bins``, ``vmin``,
``vmax``, ``log_std_min``, ``log_std_max``.
"""
import torch
import torch.nn.functional as F

# Float32 products: on an NVIDIA card PyTorch may otherwise run them in TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LN_EPS = 1e-5


def layer_norm(x, scale, shift):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * scale + shift


def mish(x):
    return x * torch.tanh(F.softplus(x))


def sim_norm(x, group):
    g = x.reshape(*x.shape[:-1], x.shape[-1] // group, group)
    e = torch.exp(g - g.max(-1, keepdim=True).values)
    return (e / e.sum(-1, keepdim=True)).reshape(x.shape)


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)


def two_hot_inv(logits, config):
    bins = torch.linspace(config["vmin"], config["vmax"], config["num_bins"],
                          device=logits.device)
    p = torch.softmax(logits, dim=-1)
    return symexp((p * bins).sum(-1))


def dense(x, layer):
    return x @ layer["w"] + layer["b"]


def head(layers, x, config, latent_out=False):
    for layer in layers[:-1]:
        x = mish(layer_norm(dense(x, layer), layer["ln_w"], layer["ln_b"]))
    last = layers[-1]
    if latent_out:
        return sim_norm(layer_norm(dense(x, last), last["ln_w"], last["ln_b"]),
                        config["simnorm_dim"])
    return dense(x, last)


def with_task(params, x):
    if "task" not in params:
        return x
    return torch.cat([x, params["task"].expand(x.shape[0], -1)], dim=-1)


def encode(params, config, obs):
    return head(params["encoder"], with_task(params, obs), config, latent_out=True)


def next_latent(params, config, z, a):
    return head(params["dynamics"], torch.cat([with_task(params, z), a], -1), config,
                latent_out=True)


def reward(params, config, z, a):
    return two_hot_inv(head(params["reward"], torch.cat([with_task(params, z), a], -1),
                            config), config)


def pi(params, config, z, eps):
    out = head(params["pi"], with_task(params, z), config)
    mean, x = out.chunk(2, dim=-1)
    low, high = config["log_std_min"], config["log_std_max"]
    log_std = low + 0.5 * (high - low) * (torch.tanh(x) + 1)
    return torch.tanh(mean + eps * torch.exp(log_std))


def q(params, config, z, a, i):
    """Q head ``i`` at ``(z, a)``, decoded: [B]."""
    layers = [{k: v[i] for k, v in layer.items()} for layer in params["q"]]
    return two_hot_inv(head(layers, torch.cat([with_task(params, z), a], -1), config), config)


def value(params, config, z, eps, pair):
    """``(Q_i + Q_j)(z, pi(z, eps)) / 2`` for ``pair = (i, j)``."""
    a = pi(params, config, z, eps)
    i, j = (int(k) for k in pair)
    return (q(params, config, z, a, i) + q(params, config, z, a, j)) / 2


def plan_value(params, config, z0, actions, eps, pair, discount):
    """Each row's ``sum_{t<H} gamma^t r_t + gamma^H V(z_H)`` from ``z0`` [B, latent] under
    ``actions`` [B, H, U]."""
    z = z0
    total = torch.zeros(z0.shape[0], device=z0.device)
    gamma = torch.ones((), device=z0.device)
    for t in range(actions.shape[1]):
        a = actions[:, t]
        total = total + gamma * reward(params, config, z, a)
        z = next_latent(params, config, z, a)
        gamma = gamma * discount
    return total + gamma * value(params, config, z, eps, pair)
