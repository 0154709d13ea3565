"""The device's idle time per ``act()`` while the host is in the solver's own code, in ms: the
innermost program span open is one of ``solver.solve``, ``solver.iteration``,
``solver.sample`` (the candidates' draw and assembly) and ``solver.update`` (top-k, the elite
mask and moments, the argmax). Read from the traced window by ``port_bench/spans.py``; nothing
to read where the program opens no span."""

from port_bench.spans import idle_ms_per_act


def read(ctx):
    return idle_ms_per_act(ctx, "solver")
