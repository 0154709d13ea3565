"""The model work of the V-JEPA 2-AC cell's ``act()``, counted from the configuration's shapes
(``configs/vjepa2_ac_300m.json``), whichever path computes it: the matrix products of the
encoder and the predictor (the linear layers and the attention's two products), and the
parameters' layout that the driver draws the weights in. LayerNorm, GELU, RoPE and the softmax
are left out: at these widths they are under 1 % of the operations.

Attention counts what the block-causal mask lets through: frame k's tokens attend to the
``(k + 1) x frame_tokens`` keys of the frames up to their own, ``2 x queries x keys x width``
multiply-adds a block (``q k^T`` and the weights times ``v``).
"""
from __future__ import annotations

__all__ = ["param_shapes", "block_macs_per_token", "frame_flops", "candidate_flops",
           "encoder_flops", "act_flops", "kv_cache_bytes"]

COND_TOKENS = 2  # a frame's action and state tokens


def _block_shapes(depth: int, dim: int, mlp: int) -> dict:
    return {"ln1_w": (depth, dim), "ln1_b": (depth, dim),
            "qkv_w": (depth, dim, 3 * dim), "qkv_b": (depth, 3 * dim),
            "proj_w": (depth, dim, dim), "proj_b": (depth, dim),
            "ln2_w": (depth, dim), "ln2_b": (depth, dim),
            "fc1_w": (depth, dim, mlp), "fc1_b": (depth, mlp),
            "fc2_w": (depth, mlp, dim), "fc2_b": (depth, dim)}


def param_shapes(config: dict) -> dict:
    """The program's parameter layout (``blackbox_mpc_torch/models/vjepa2_ac.py``), a shape in
    place of each tensor: matrices ``[in, out]``, the blocks' tensors stacked over the depth."""
    m = config["model"]
    e, p = m["enc_dim"], m["pred_dim"]
    patch_in = 3 * m["tubelet_size"] * m["patch_size"] ** 2
    return {
        "encoder": {"patch_w": (patch_in, e), "patch_b": (e,),
                    "blocks": _block_shapes(m["enc_depth"], e, m["enc_mlp_dim"]),
                    "norm_w": (e,), "norm_b": (e,)},
        "predictor": {"action_w": (m["action_dim"], p), "action_b": (p,),
                      "state_w": (m["state_dim"], p), "state_b": (p,),
                      "embed_w": (e, p), "embed_b": (p,),
                      "blocks": _block_shapes(m["pred_depth"], p, m["pred_mlp_dim"]),
                      "norm_w": (p,), "norm_b": (p,), "out_w": (p, e), "out_b": (e,)},
    }


def _patches(m: dict) -> int:
    return (m["image_size"] // m["patch_size"]) ** 2


def block_macs_per_token(dim: int, mlp: int) -> int:
    """A block's linear layers, per token: ``qkv``, the projection and the MLP."""
    return dim * 3 * dim + dim * dim + 2 * dim * mlp


def frame_flops(config: dict, keys: int) -> float:
    """One imagined frame of one candidate whose tokens attend to ``keys`` keys: the action,
    state and patch embeddings, the predictor's blocks, the read-out of the patches."""
    m = config["model"]
    patches, p, e = _patches(m), m["pred_dim"], m["enc_dim"]
    tokens = COND_TOKENS + patches
    embed = (m["action_dim"] + m["state_dim"]) * p + patches * e * p + patches * p * e
    blocks = m["pred_depth"] * (tokens * block_macs_per_token(p, m["pred_mlp_dim"])
                                + 2 * tokens * keys * p)
    return 2.0 * (embed + blocks)


def candidate_flops(config: dict, horizon: int) -> float:
    """One candidate's rollout of ``horizon`` frames, frame k attending to k + 1 frames."""
    tokens = COND_TOKENS + _patches(config["model"])
    return sum(frame_flops(config, (k + 1) * tokens) for k in range(horizon))


def encoder_flops(config: dict) -> float:
    """One image through the encoder: the patch embedding and the blocks."""
    m = config["model"]
    patches, e = _patches(m), m["enc_dim"]
    patch_in = 3 * m["tubelet_size"] * m["patch_size"] ** 2
    blocks = m["enc_depth"] * (patches * block_macs_per_token(e, m["enc_mlp_dim"])
                               + 2 * patches * patches * e)
    return 2.0 * (patches * patch_in * e + blocks)


def act_flops(config: dict, traffic: dict) -> float:
    """The model FLOPs of one ``act()``: every candidate of every agent and iteration, and per
    agent the observation's encoder pass and the one-step lookahead (frame 0 alone). The goal's
    encoder pass, once an episode, is left out."""
    kw, agents = traffic["solver_kwargs"], traffic["agents"]
    tokens = COND_TOKENS + _patches(config["model"])
    solve = (kw["population"] * agents * kw["max_iterations"]
             * candidate_flops(config, traffic["planning_horizon"]))
    return solve + agents * (encoder_flops(config) + frame_flops(config, tokens))


def kv_cache_bytes(config: dict, rows: int, horizon: int) -> int:
    """The predictor's cache of the frames before the last, float32: every block's keys and
    values of ``horizon - 1`` frames of ``rows`` rows."""
    m = config["model"]
    tokens = COND_TOKENS + _patches(m)
    return m["pred_depth"] * 2 * rows * (horizon - 1) * tokens * m["pred_dim"] * 4
