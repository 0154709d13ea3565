"""The device's idle time per ``act()`` while the host is inside a ``models.*`` span, in ms:
``models.step`` (an eager step of the dynamics and the reward over every row), the spans a
model opens inside it or beside it (``models.reward``, the decoded reward head; a latent
model's ``models.encode`` and ``models.value``; a recurrent model's ``models.observe``, the
filter step of each call). An evaluation that replays a CUDA graph opens none of the step's.
Read from the traced window by ``port_bench/spans.py``; nothing to read where the program opens
no span."""

from port_bench.spans import idle_ms_per_act


def read(ctx):
    return idle_ms_per_act(ctx, "models")
