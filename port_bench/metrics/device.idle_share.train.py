"""The share of the traced ``train()`` window in which no operation ran on the device, in
%."""

from port_bench.trace import device_busy_us


def read(ctx):
    traced = ctx["traced"]
    if not traced.device_ops():
        return None
    return 100.0 * (1.0 - device_busy_us(traced) / (traced.hi_us - traced.lo_us))
