"""The attention kernels' share of the device's busy time in the traced window, in %: the device
time of the kernels named below (those that ``models.attend``, around V-JEPA 2-AC's
``scaled_dot_product_attention`` calls, launches on the card in float32: the memory-efficient
attention's forward kernels) over the time in which any device operation ran. Lower is better:
an attention that takes less of the step's time, beside the same gemms. Nothing to read where no
such kernel ran."""

from port_bench.trace import device_busy_us

ATTENTION_KERNELS = ("fmha_cutlassF",)


def read(ctx):
    traced = ctx["traced"]
    ops = [e for e in traced.device_ops() if any(k in e.name for k in ATTENTION_KERNELS)]
    if not ops:
        return None
    return 100.0 * sum(e.end_us - e.start_us for e in ops) / device_busy_us(traced)
