"""The whole planning step's share of the card's peak, in %: the model FLOPs of every
``act()`` in the traced window (``work.act_flops``: the MLP forward over every rolled-out
row, member or particle, step and iteration), over the window's length times the peak of
the configuration's dtype (f32: 67 TFLOP/s)."""


def read(ctx):
    work, traced = ctx["work"], ctx["traced"]
    if not work.get("acts"):
        return None
    return 100.0 * work["flops_per_act"] * work["acts"] / (traced.window_s * work["peak_flops"])
