"""Registers the V-JEPA 2-AC cell's tiny size (``port_bench/tests/tiny_vjepa2.py``) in
``port_bench/tests/tiny.py``'s ``TINY`` before any test collects, so that the harness's dry
tests drive every cell of ``BENCHMARK.json``. It imports nothing but the standard library:
``tests/conftest.py`` still sets JAX's platform before anything loads it."""
from port_bench.tests.tiny import TINY
from port_bench.tests.tiny_vjepa2 import CELL, SIZES

TINY.setdefault(CELL, SIZES)
