"""The host's calls that put work on the device (``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
``cuLaunchKernel*``, ``cudaMemcpyAsync``, ``cudaMemsetAsync``) made while the innermost
program span open is ``models.step``, per ``act()``, in the PETS controller's cell: the share
of ``solver.device_ops_per_act.pets`` that the model layer dispatches. Read from the traced
window by ``port_bench/spans.py``; nothing to read where the program opens no span."""

from port_bench.spans import launches_by_span


def read(ctx):
    acts = ctx["work"].get("acts")
    by_span = launches_by_span(ctx["traced"])
    if not acts or by_span is None:
        return None
    return by_span.get("models.step", 0) / acts
