"""Device operations (kernels, copies, sets) per ``act()`` in the traced window: what the
solver, the evaluator and the models launch, and what an eager path's host dispatch pays
for."""


def read(ctx):
    acts = ctx["work"].get("acts")
    if not acts:
        return None
    return len(ctx["traced"].device_ops()) / acts
