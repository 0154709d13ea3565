"""Host-to-device copies per optimizer step in the traced window (the replay is held on the
host, so each minibatch crosses to the card)."""


def read(ctx):
    steps = ctx["work"].get("train_steps")
    if not steps:
        return None
    copies = sum(1 for e in ctx["traced"].device_ops() if e.name.startswith("Memcpy HtoD"))
    return copies / steps
