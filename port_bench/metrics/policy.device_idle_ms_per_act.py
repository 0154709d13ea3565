"""The device's idle time per ``act()`` while the host is in the policy's own code, in ms:
the innermost program span open is one of ``policy.act``, ``policy.obs_in`` (the observation's
copy to the device), ``policy.lookahead`` and ``policy.wait`` (the read-back of the action).
Read from the traced window by ``port_bench/spans.py``; nothing to read where the program
opens no span."""

from port_bench.spans import idle_ms_per_act


def read(ctx):
    return idle_ms_per_act(ctx, "policy")
