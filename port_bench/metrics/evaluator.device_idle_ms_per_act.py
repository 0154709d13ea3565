"""The device's idle time per ``act()`` while the host is in the evaluator's own code, in ms:
the innermost program span open is ``evaluator.evaluate`` (the states' tiling, the kernel's
operands and rewards, the rollout noise's draw; not its ``models.step`` or ``kernels.*``
spans). Read from the traced window by ``port_bench/spans.py``; nothing to read where the
program opens no span."""

from port_bench.spans import idle_ms_per_act


def read(ctx):
    return idle_ms_per_act(ctx, "evaluator")
