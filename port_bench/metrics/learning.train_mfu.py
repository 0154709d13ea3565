"""Training's share of the card's peak, in %: forward and backward FLOPs of every optimizer
step in the traced window (``work.train_flops_per_step``, three times the forward of each
member's minibatch), over the window's length times the peak of the configuration's dtype."""


def read(ctx):
    work, traced = ctx["work"], ctx["traced"]
    if not work.get("train_steps"):
        return None
    flops = work["flops_per_step"] * work["train_steps"]
    return 100.0 * flops / (traced.window_s * work["peak_flops"])
