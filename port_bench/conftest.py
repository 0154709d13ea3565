"""Registers the RSSM cell's tiny size (``tests/tiny_rssm.py``) in ``tests/tiny.py``'s ``TINY``
before the tests collect, so that ``tests/test_port_bench_dry.py`` and the others drive every
cell of ``BENCHMARK.json`` on the dry path (``tests/conftest.py`` registers the TD-MPC2
cell's)."""
from port_bench.tests.tiny import TINY
from port_bench.tests.tiny_rssm import CELL, SIZES

TINY.setdefault(CELL, SIZES)
