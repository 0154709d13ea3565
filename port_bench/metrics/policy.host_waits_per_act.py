"""The host's waits for the device per ``act()``: ``cudaStreamSynchronize`` calls in the
traced window (a blocking copy or a read of a device value each), over the calls."""


def read(ctx):
    acts = ctx["work"].get("acts")
    if not acts:
        return None
    return ctx["traced"].host_calls("cudaStreamSynchronize") / acts
