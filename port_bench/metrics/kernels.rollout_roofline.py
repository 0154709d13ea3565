"""The rollout kernels' share of their roofline, in %: the least time one ``act()``'s
rollouts need on the card (``work.rollout_least_ms_per_act``: the MLP's operations at the f32
SIMT peak or its bytes at the HBM rate, whichever binds, once per iteration), over the device
time per ``act()`` of the kernels named below (K2; K4 and K5). Nothing to read where no such
kernel ran."""

ROLLOUT_KERNELS = ("rollout_kernel", "fused_rollout_kernel")


def read(ctx):
    work = ctx["work"]
    ops = [e for e in ctx["traced"].device_ops()
           if any(k in e.name for k in ROLLOUT_KERNELS)]
    if not ops or not work.get("acts"):
        return None
    kernel_ms_per_act = sum(e.end_us - e.start_us for e in ops) / 1e3 / work["acts"]
    return 100.0 * work["rollout_least_ms_per_act"] / kernel_ms_per_act
