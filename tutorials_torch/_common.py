"""Shared tutorial plumbing: device selection and argument defaults.

The torch twins of ``tutorials/`` run on the card (``cuda``) by default, as every entry point
of ``blackbox_mpc_torch`` does; pass ``--cpu`` to run on the CPU instead. Without a card and
without ``--cpu`` a tutorial stops with the port's device error: it never moves to the CPU on
its own.
"""
import argparse
import logging


def setup(description: str, **extra_args) -> argparse.Namespace:
    """Parses ``--cpu``, ``--seed`` and ``extra_args`` (``--name-with-dashes``, typed by the
    default); ``args.device`` is the resolved ``torch.device`` to pass to the entry points."""
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    parser.add_argument("--seed", type=int, default=0)
    for name, default in extra_args.items():
        parser.add_argument(f"--{name.replace('_', '-')}", type=type(default), default=default)
    args, _unknown = parser.parse_known_args()
    from blackbox_mpc_torch.core.device import resolve_device

    try:
        args.device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    return args
