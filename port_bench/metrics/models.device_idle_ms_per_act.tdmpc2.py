"""The device's idle time per ``act()`` while the host is inside a ``models.*`` span, in ms, in
the TD-MPC2 cell: ``models.encode`` (the observation's encoding, once a call),
``models.step`` (an eager step of the dynamics and the reward), ``models.reward`` (the decoded
reward head, inside it) and ``models.value`` (``pi`` and the Q pair at the rollout's end). An
evaluation that replays a CUDA graph opens none but ``models.encode``. Read from the traced
window by ``port_bench/spans.py``; nothing to read where the program opens no span."""

from port_bench.spans import idle_ms_per_act


def read(ctx):
    return idle_ms_per_act(ctx, "models")
