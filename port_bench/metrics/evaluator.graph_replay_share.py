"""The share of the evaluations that replay a CUDA graph, in %: 100 x the ``evaluator.replay``
spans over the ``evaluator.evaluate`` spans of the traced window (the program's graphed eager
evaluator, ``blackbox_mpc_torch/rollout/evaluator.py::GraphedEvaluator``). 0 where the program
evaluates without replaying; nothing to read where it opens no span or no evaluation."""

from port_bench.spans import program_spans


def read(ctx):
    names = [e.name for e in program_spans(ctx["traced"])]
    evaluations = names.count("evaluator.evaluate")
    if not evaluations:
        return None
    return 100.0 * names.count("evaluator.replay") / evaluations
