"""V-JEPA 2-AC's action-conditioned world model and one CEM planning step toward a goal image
through it, written out plainly in float32 PyTorch for the tests of
``blackbox_mpc_torch/models/vjepa2_ac.py``. It imports nothing of that package (nor JAX).

Written from Assran et al., *V-JEPA 2: Self-Supervised Video Models Enable Understanding,
Prediction and Planning* (arXiv:2506.09985): section 3 (the action-conditioned predictor) and
section 4 (planning by CEM on an L1 energy to a goal image's representation), and the layout of
its code (github.com/facebookresearch/vjepa2: the encoder ``vit_giant_xformers``, the predictor
``vit_ac_predictor``).

* Encoder: the image in [0, 1], normalised by ImageNet's mean (0.485, 0.456, 0.406) and std
  (0.229, 0.224, 0.225), repeated into a ``tubelet_size``-frame clip; ``Conv3d(3 -> enc_dim,
  kernel = stride = (tubelet, patch, patch))`` with bias; ``enc_depth`` blocks
  ``x += Proj(Attn(LN(x)))``, ``x += W2 GELU(W1 LN(x))`` (LN with eps ``ln_eps`` and an affine,
  GELU the exact one); a final LN. The frame latent is that output under a LayerNorm with no
  affine (eps ``latent_eps``).
* Attention: ``qkv`` one Linear with bias over heads of ``dim / heads``; q and k rotated by a
  3-D RoPE; ``softmax(q k^T / sqrt(head_dim) + mask) v``, written out.
* RoPE: a head's first ``3 * part`` units, ``part = 2 * ((head_dim // 3) // 2)``, are a
  temporal, a height and a width part; in each, unit pair ``(2i, 2i + 1)`` is one complex
  number, multiplied by ``exp(1j * pos * 10000^(-2i / part))`` with ``pos`` the token's
  coordinate on that axis. The rest of the head is not rotated.
* Predictor: frame k is the tokens ``[a_k W_a, s_k W_s, z_k W_in]`` (each Linear with bias), the
  action and state tokens at position ``(k, 0, 0)`` (time alone), the patch of row i and column
  j at ``(k, i, j)``; ``pred_depth`` blocks as the encoder's under a block-causal mask (a token
  of frame k attends to every token of the frames up to k); a LN and ``W_out`` on the patch
  tokens give the prediction of frame k + 1.
* A rollout from ``(z_0, s_0)`` under actions ``a_0 .. a_{H-1}`` runs the predictor's whole
  forward over the frames so far for each imagined frame, with the frames before it
  teacher-forced from its own predictions, and no cache: ``z_{k+1}`` is the last frame's
  output over frames ``0..k``; ``s_{k+1} = s_k + a_k``.
* Energy: ``mean |z_H - z_goal|`` over the frame's latents. A candidate's value is minus it.

Every matrix product, the patch embedding's and the attention's two included, is one call of
the ``mm`` that the model's functions take (``torch.matmul`` by default), so that a caller can
compute them in another precision; the patch embedding is the product of each patch's pixels,
in ``Conv3d``'s weight order, with the embedding's matrix, which is ``Conv3d`` at kernel =
stride.

Assumed where the public code was not at hand: the frame latent's LayerNorm with no affine, the
token order (action, state, patches), the action and state tokens' time-only position, the
state's integration of the actions, and each RoPE pair turned by one angle (a rotation).
Departures, each the caller's to make: the planner is the port's CEM (a normal truncated at two
standard deviations around the mean, the variance capped so that two of them stay inside the
bounds, the top ``num_elite`` per agent, the blend with ``alpha``), where the paper's CEM keeps
its samples in a ball; its draws are arguments.

``config``: a mapping with the keys of ``blackbox_mpc_torch.models.vjepa2_ac.VJEPA2ACConfig``.
Parameters: ``{"encoder": {...}, "predictor": {...}}``, matrices ``[in, out]`` (the patch
embedding ``patch_w`` [3 x tubelet x patch x patch, enc_dim], its rows in ``Conv3d``'s weight
order: channel, time, row, column), each block's tensors stacked over the depth (``qkv_w``
[depth, dim, 3 dim], ``ln1_w`` [depth, dim], ...).
"""
import math

import torch

# Float32 products: on an NVIDIA card PyTorch may otherwise run them in TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SQRT2 = math.sqrt(2.0)
ERF_LO, ERF_HI = math.erf(-2.0 / SQRT2), math.erf(2.0 / SQRT2)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
THETA = 10000.0
COND = 2  # the action and state tokens of a frame


def layer_norm(x, scale, shift, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    out = (x - mean) / torch.sqrt(var + eps)
    return out if scale is None else out * scale + shift


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / SQRT2))


def dense(x, w, b, mm=torch.matmul):
    return mm(x, w) + b


def rope(x, pos):
    """``x`` [..., N, head_dim], ``pos`` [N, 3] (time, row, column)."""
    d = x.shape[-1]
    part = 2 * ((d // 3) // 2)
    freqs = THETA ** (-2.0 * torch.arange(part // 2, dtype=torch.float32, device=x.device)
                      / part)
    pieces = []
    for axis in range(3):
        seg = x[..., axis * part:(axis + 1) * part].float().contiguous()
        c = torch.view_as_complex(seg.reshape(*seg.shape[:-1], part // 2, 2))
        angle = pos[:, axis, None].float() * freqs  # [N, part / 2]
        turned = c * torch.polar(torch.ones_like(angle), angle)
        pieces.append(torch.view_as_real(turned).reshape(seg.shape))
    pieces.append(x[..., 3 * part:])
    return torch.cat(pieces, dim=-1)


def attend(q, k, v, mask=None, mm=torch.matmul):
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    return mm(torch.softmax(scores, dim=-1), v)


def block(x, blocks, i, heads, pos, eps, mask=None, mm=torch.matmul):
    b, n, d = x.shape
    h = layer_norm(x, blocks["ln1_w"][i], blocks["ln1_b"][i], eps)
    qkv = dense(h, blocks["qkv_w"][i], blocks["qkv_b"][i], mm)
    qkv = qkv.reshape(b, n, 3, heads, d // heads)
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))  # [B, heads, N, head_dim]
    o = attend(rope(q, pos), rope(k, pos), v, mask, mm)
    x = x + dense(o.transpose(1, 2).reshape(b, n, d), blocks["proj_w"][i], blocks["proj_b"][i],
                  mm)
    h = layer_norm(x, blocks["ln2_w"][i], blocks["ln2_b"][i], eps)
    h = gelu(dense(h, blocks["fc1_w"][i], blocks["fc1_b"][i], mm))
    return x + dense(h, blocks["fc2_w"][i], blocks["fc2_b"][i], mm)


def grid_positions(config, t):
    g = config["image_size"] // config["patch_size"]
    return [(t, i, j) for i in range(g) for j in range(g)]


def patches(config, images):
    """``images`` [B, 3, H, W], each repeated over a tubelet -> [B, patches, 3 x tubelet x
    patch x patch]: the patches row-major over (row, column), each one's pixels in ``Conv3d``'s
    weight order (channel, time, row, column)."""
    t, p = config["tubelet_size"], config["patch_size"]
    b, g = images.shape[0], config["image_size"] // p
    x = images.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)  # [B, g, g, 3, p, p]
    return torch.stack([x] * t, dim=4).reshape(b, g * g, 3 * t * p * p)


def encode(params, config, images, mm=torch.matmul):
    """``images`` [B, 3, H, W] in [0, 1] -> frame latents [B, patches, enc_dim]."""
    enc = params["encoder"]
    mean = torch.tensor(MEAN, device=images.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=images.device).view(1, 3, 1, 1)
    x = dense(patches(config, (images - mean) / std), enc["patch_w"], enc["patch_b"], mm)
    pos = torch.tensor(grid_positions(config, 0), device=images.device)
    for i in range(config["enc_depth"]):
        x = block(x, enc["blocks"], i, config["enc_heads"], pos, config["ln_eps"], mm=mm)
    x = layer_norm(x, enc["norm_w"], enc["norm_b"], config["ln_eps"])
    return layer_norm(x, None, None, config["latent_eps"])


def predict(params, config, z, s, a, mm=torch.matmul):
    """The predictor's whole forward over F frames, block-causal: ``z`` [B, F, patches,
    enc_dim], ``s`` [B, F, state_dim], ``a`` [B, F, action_dim] -> [B, F, patches, enc_dim],
    frame k's the prediction of frame k + 1."""
    pred = params["predictor"]
    b, frames, patches, _ = z.shape
    tokens, pos = [], []
    for f in range(frames):
        tokens += [dense(a[:, f], pred["action_w"], pred["action_b"], mm)[:, None],
                   dense(s[:, f], pred["state_w"], pred["state_b"], mm)[:, None],
                   dense(z[:, f], pred["embed_w"], pred["embed_b"], mm)]
        pos += [(f, 0, 0)] * COND + grid_positions(config, f)
    x = torch.cat(tokens, dim=1)
    n = COND + patches
    frame_of = torch.arange(frames * n, device=z.device) // n
    mask = frame_of[:, None] >= frame_of[None, :]
    pos = torch.tensor(pos, device=z.device)
    for i in range(config["pred_depth"]):
        x = block(x, pred["blocks"], i, config["pred_heads"], pos, config["ln_eps"], mask, mm)
    x = x.reshape(b, frames, n, -1)[:, :, COND:]
    x = layer_norm(x, pred["norm_w"], pred["norm_b"], config["ln_eps"])
    return dense(x, pred["out_w"], pred["out_b"], mm)


def rollout(params, config, z0, s0, actions, mm=torch.matmul):
    """``z0`` [B, patches, enc_dim], ``s0`` [B, state_dim], ``actions`` [B, H, action_dim] ->
    (the imagined frames' latents [B, H, patches, enc_dim], states [B, H, state_dim]), each
    frame from the predictor's forward over every frame before it, no cache."""
    zs, ss = [z0], [s0]
    for k in range(actions.shape[1]):
        out = predict(params, config, torch.stack(zs, 1), torch.stack(ss, 1),
                      actions[:, :k + 1], mm)
        zs.append(out[:, -1])
        ss.append(ss[-1] + actions[:, k])
    return torch.stack(zs[1:], 1), torch.stack(ss[1:], 1)


def energy(z, goal):
    """``mean |z - goal|`` over each row's latents: [B]."""
    return (z - goal).abs().flatten(1).mean(1)


def returns(params, config, z0, s0, plans, goal):
    """``plans`` [B, H, U] from the rows' ``z0``, ``s0`` -> minus the last frame's energy,
    [B]."""
    zs, _ = rollout(params, config, z0, s0, plans)
    return -energy(zs[:, -1], goal)


def cem_act(params, config, z0, s0, goal, mean, var, draws, num_elite, alpha, low, high):
    """One ``act()``'s CEM from the agents' ``z0`` [A, patches, enc_dim], ``s0`` [A, state_dim]
    and the carried ``mean``/``var`` [A, H, U]: ``draws`` holds each iteration's standard
    truncated normals [P, A, H, U], rows candidate-major then agent. Returns ``(action [A, U],
    final mean, mean value of the last iteration's elites [A])``."""
    for zs in draws:
        pop, agents, horizon, dim_u = zs.shape
        cap = torch.minimum(((mean - low) / 2) ** 2, ((high - mean) / 2) ** 2)
        samples = mean + zs * torch.sqrt(torch.minimum(cap, var))
        total = returns(params, config, z0.repeat(pop, 1, 1), s0.repeat(pop, 1),
                        samples.reshape(pop * agents, horizon, dim_u), goal)
        total = torch.where(torch.isnan(total), torch.full_like(total, -1e6), total)
        values, best = torch.topk(total.reshape(pop, agents).T, num_elite, dim=1)  # [A, k]
        elites = torch.stack([samples[best[j], j] for j in range(agents)])  # [A, k, H, U]
        elite_mean = elites.mean(1)
        elite_var = ((elites - elite_mean[:, None]) ** 2).mean(1)
        mean = alpha * mean + (1 - alpha) * elite_mean
        var = alpha * var + (1 - alpha) * elite_var
    return mean[:, 0], mean, values.mean(1)


def truncated_normals(generator, shape, device=None):
    """Standard normals truncated at +/-2 by inverse CDF, one ``torch.rand`` of ``shape``."""
    u = torch.rand(shape, generator=generator, device=device)
    return torch.clamp(SQRT2 * torch.erfinv(ERF_LO + (ERF_HI - ERF_LO) * u), -2.0, 2.0)
