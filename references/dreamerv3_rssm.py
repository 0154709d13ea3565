"""DreamerV3's recurrent state-space model (RSSM) and one PlaNet planning step through it,
written out plainly in float32 PyTorch for the tests of ``blackbox_mpc_torch/models/rssm.py``.
It imports nothing of that package (nor JAX).

Written from Hafner, Pasukonis, Ba and Lillicrap, *Mastering Diverse Domains through World
Models* (arXiv:2301.04104), its code (github.com/danijar/dreamerv3: ``dreamerv3/rssm.py``,
``configs.yaml``'s ``size200m``, the reward head of ``agent.py``), and PlaNet's planner (Hafner
et al., *Learning Latent Dynamics for Planning from Pixels*, arXiv:1811.04551, section 3).

* A hidden layer is Linear, RMSNorm (``x / sqrt(mean(x^2) + eps) * scale``, a learned scale),
  SiLU. A head's last layer is a plain Linear. Every Linear has a bias.
* The feature is ``[h, z]``: ``h`` the deterministic state (``deter``), ``z`` the ``stoch``
  one-hot codes of ``classes`` classes, flattened.
* The core (``rssm.py::_core``): ``x0, x1, x2`` = a hidden layer each of ``h``, ``z`` and
  ``a / max(1, |a|)`` (``hidden`` wide); group ``g`` of ``blocks`` reads ``[h_g, x0, x1, x2]``;
  ``dyn_layers`` block-diagonal hidden layers (each group its own weights; the RMSNorm over
  all ``deter`` units of a row), then a block-diagonal layer whose group ``g`` gives ``[r_g,
  c_g, v_g]``; ``h' = s(v - 1) * tanh(s(r) * c) + (1 - s(v - 1)) * h`` with ``s`` the
  sigmoid. The block layers are written here group by group.
* The prior: ``img_layers`` hidden layers of ``h'``, then the codes' logits; the posterior:
  ``obs_layers`` hidden layers of ``[h', e]``, then the logits; ``e``: ``enc_layers`` hidden
  layers of ``units`` over ``symlog(obs)``. Probabilities: ``(1 - unimix) softmax + unimix /
  classes`` (unimix).
* A code is drawn from its probabilities by inverse CDF: the first class whose cumulative sum
  passes a uniform. That is the law of ``jax.random.categorical`` over the same
  probabilities; the uniforms are arguments.
* The reward head: ``reward_layers`` hidden layers of ``units`` over ``feat``, then
  ``num_bins`` logits, decoded as the released code's ``TwoHot`` with ``symexp``:
  ``symexp(sum(softmax * linspace(vmin, vmax, num_bins)))``. The paper writes the expectation
  over ``symexp``-spaced bins instead; this follows the code, summed left to right (the code
  sums the two halves of the bins outward from the middle, so that uniform probabilities give
  exactly 0).
* PlaNet's planner scores a candidate by the sum of the predicted rewards along one trajectory
  drawn from the prior, each reward read at the state a step reaches; no discount.

Departures, each the caller's to make: the uniforms of every draw are arguments; the planner
is the port's CEM (a normal truncated at two standard deviations around the mean, the variance
capped so that two of them stay inside the bounds, the top ``num_elite`` per agent, the blend
with ``alpha``), where PlaNet draws an unclipped normal of std 1 and refits.

``config``: a mapping with the keys of ``blackbox_mpc_torch.models.rssm.RSSMConfig``.
Parameters: a dictionary of heads, each a list of layers ``{"w": [in, out], "b": [out]}`` with
``"scale"`` on a hidden layer: ``"encoder"``, ``"core_in"`` (of ``h``, ``z``, ``a``),
``"core_hidden"`` and ``"core_gru"`` (``w`` [blocks, in, out], ``b`` [blocks, out]; a hidden
one's ``scale`` [deter]), ``"prior"``, ``"posterior"``, ``"reward"``.
"""
import math

import torch
import torch.nn.functional as F

# Float32 products: on an NVIDIA card PyTorch may otherwise run them in TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SQRT2 = math.sqrt(2.0)
ERF_LO, ERF_HI = math.erf(-2.0 / SQRT2), math.erf(2.0 / SQRT2)


def rms_norm(x, scale, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def silu(x):
    return x * torch.sigmoid(x)


def symlog(x):
    return torch.sign(x) * torch.log(1 + torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)


def dense(x, layer):
    return x @ layer["w"] + layer["b"]


def hidden(x, layer, config):
    return silu(rms_norm(dense(x, layer), layer["scale"], config["norm_eps"]))


def head(layers, x, config):
    for layer in layers[:-1]:
        x = hidden(x, layer, config)
    return dense(x, layers[-1])


def block_linear(x, layer):
    """``x`` [B, blocks * in]: group ``g`` (its ``in`` columns) through its own weights, the
    groups' outputs side by side, [B, blocks * out]."""
    w, b = layer["w"], layer["b"]
    k = w.shape[1]
    return torch.cat([x[:, g * k:(g + 1) * k] @ w[g] + b[g] for g in range(w.shape[0])], -1)


def core(params, config, h, z, a):
    """``h'`` from ``h`` [B, deter], ``z`` [B, stoch * classes], ``a`` [B, U]."""
    blocks, eps = config["blocks"], config["norm_eps"]
    k = config["deter"] // blocks
    a = a / torch.clamp(torch.abs(a), min=1.0)
    x = torch.cat([hidden(v, layer, config) for v, layer in zip((h, z, a), params["core_in"])],
                  -1)
    x = torch.cat([torch.cat([h[:, g * k:(g + 1) * k], x], -1) for g in range(blocks)], -1)
    for layer in params["core_hidden"]:
        x = silu(rms_norm(block_linear(x, layer), layer["scale"], eps))
    gates = block_linear(x, params["core_gru"][0])
    new = []
    for g in range(blocks):
        r, c, v = gates[:, 3 * k * g:3 * k * (g + 1)].split(k, -1)
        update = torch.sigmoid(v - 1)
        new.append(update * torch.tanh(torch.sigmoid(r) * c)
                   + (1 - update) * h[:, g * k:(g + 1) * k])
    return torch.cat(new, -1)


def code_probs(config, logits):
    """[B, stoch * classes] logits -> unimix probabilities [B, stoch, classes]."""
    p = torch.softmax(logits.reshape(logits.shape[0], config["stoch"], config["classes"]), -1)
    return (1 - config["unimix"]) * p + config["unimix"] / config["classes"]


def prior_probs(params, config, h):
    return code_probs(config, head(params["prior"], h, config))


def posterior_probs(params, config, h, e):
    return code_probs(config, head(params["posterior"], torch.cat([h, e], -1), config))


def encode(params, config, obs):
    x = symlog(obs)
    for layer in params["encoder"]:
        x = hidden(x, layer, config)
    return x


def pick(probs, u, program=None, margin=0.0):
    """The classes [B, stoch] drawn by inverse CDF from ``probs`` [B, stoch, classes] with the
    uniforms ``u`` [B, stoch], and ``(ties, mismatches)``. Given the classes another
    computation picked (``program`` [B, stoch]), a pick whose uniform lies within ``margin``
    of one of its cumulative sums is a tie, and the other's class is taken there: ``ties``
    counts the ties where the two differ, ``mismatches`` the other picks where they
    differ."""
    cdf = torch.cumsum(probs, -1)
    own = torch.clamp((cdf <= u[..., None]).sum(-1), max=probs.shape[-1] - 1)
    if program is None:
        return own, 0, 0
    program = program.to(own.dtype)
    near = (torch.abs(cdf[..., :-1] - u[..., None]) < margin).any(-1)
    differ = own != program
    return (torch.where(near, program, own), int((near & differ).sum()),
            int((~near & differ).sum()))


def one_hot(index, config):
    return F.one_hot(index, config["classes"]).float().reshape(index.shape[0], -1)


def split(feat, config):
    return feat[:, :config["deter"]], feat[:, config["deter"]:]


def observe(params, config, feat, a, obs, u, program=None, margin=0.0):
    """The filter step: ``(feat_t, ties, mismatches)`` from the last feature and action, the
    observation and the posterior's uniforms ``u`` [B, stoch] (``program``, ``margin``: as
    :func:`pick`)."""
    h, z = split(feat, config)
    h = core(params, config, h, z, a)
    index, ties, mismatches = pick(posterior_probs(params, config, h,
                                                   encode(params, config, obs)),
                                   u, program, margin)
    return torch.cat([h, one_hot(index, config)], -1), ties, mismatches


def reward(params, config, feat):
    bins = torch.linspace(config["vmin"], config["vmax"], config["num_bins"],
                          device=feat.device)
    p = torch.softmax(head(params["reward"], feat, config), -1)
    return symexp((p * bins).sum(-1))


def imagine(params, config, feat, a, u=None, program=None, margin=0.0):
    """One imagined step: ``(feat', ties, mismatches, classes)``, the codes drawn from the
    prior with ``u`` [B, stoch] (``program``, ``margin``: as :func:`pick`); with ``u`` None,
    the prior's probabilities stand for the codes."""
    h, z = split(feat, config)
    h = core(params, config, h, z, a)
    probs = prior_probs(params, config, h)
    if u is None:
        return torch.cat([h, probs.reshape(h.shape[0], -1)], -1), 0, 0, None
    index, ties, mismatches = pick(probs, u, program, margin)
    return torch.cat([h, one_hot(index, config)], -1), ties, mismatches, index


def returns(params, config, feat0, plans, u, program=None, margin=0.0):
    """PlaNet's score of each row: the rewards summed along the trajectory of ``plans`` [B, H,
    U] from ``feat0`` [B, F], step ``t``'s codes drawn with ``u[t]`` [B, stoch]. ``(returns
    [B], ties, mismatches, classes [H, B, stoch])``; ``program`` [H, B, stoch]: as
    :func:`pick`."""
    feat, total = feat0, torch.zeros(feat0.shape[0], device=feat0.device)
    ties = mismatches = 0
    picked = []
    for t in range(plans.shape[1]):
        feat, n_ties, n_mismatches, index = imagine(
            params, config, feat, plans[:, t], u[t],
            None if program is None else program[t], margin)
        total = total + reward(params, config, feat)
        ties, mismatches = ties + n_ties, mismatches + n_mismatches
        picked.append(index)
    return total, ties, mismatches, torch.stack(picked)


def cem_act(params, config, feat0, mean, var, draws, u, num_elite, alpha, low, high,
            program=None, margin=0.0):
    """One ``act()``'s CEM from the agents' features ``feat0`` [A, F] and the carried
    ``mean``/``var`` [A, H, U]: ``draws`` holds each iteration's standard truncated normals
    [P, A, H, U], ``u`` [H, P * A, stoch] the codes' uniforms of every evaluation (common
    random numbers), rows candidate-major then agent. ``program``: one classes tensor [H, P *
    A, stoch] an iteration (as :func:`pick`). Returns ``(action [A, U], final mean, ties,
    mismatches)``."""
    ties = mismatches = 0
    for i, zs in enumerate(draws):
        pop, agents, horizon, dim_u = zs.shape
        cap = torch.minimum(((mean - low) / 2) ** 2, ((high - mean) / 2) ** 2)
        samples = mean + zs * torch.sqrt(torch.minimum(cap, var))
        total, n_ties, n_mismatches, _ = returns(
            params, config, feat0.repeat(pop, 1), samples.reshape(pop * agents, horizon, dim_u),
            u, None if program is None else program[i], margin)
        ties, mismatches = ties + n_ties, mismatches + n_mismatches
        total = torch.where(torch.isnan(total), torch.full_like(total, -1e6), total)
        best = torch.topk(total.reshape(pop, agents).T, num_elite, dim=1).indices  # [A, k]
        elites = torch.stack([samples[best[j], j] for j in range(agents)])  # [A, k, H, U]
        elite_mean = elites.mean(1)
        elite_var = ((elites - elite_mean[:, None]) ** 2).mean(1)
        mean = alpha * mean + (1 - alpha) * elite_mean
        var = alpha * var + (1 - alpha) * elite_var
    return mean[:, 0], mean, ties, mismatches


def truncated_normals(generator, shape, device=None):
    """Standard normals truncated at +/-2 by inverse CDF, one ``torch.rand`` of ``shape``."""
    u = torch.rand(shape, generator=generator, device=device)
    return torch.clamp(SQRT2 * torch.erfinv(ERF_LO + (ERF_HI - ERF_LO) * u), -2.0, 2.0)
