"""The device's idle time per ``act()`` while the host is inside ``models.step`` (one eager
step of the dynamics and the reward over every row), in ms, in the PETS controller's cell.
Read from the traced window by ``port_bench/spans.py``; nothing to read where the program
opens no span."""

from port_bench.spans import idle_ms_per_act


def read(ctx):
    return idle_ms_per_act(ctx, "models")
