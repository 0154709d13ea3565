"""Nothing the harness runs loads JAX or the JAX package, and the references load nothing of
the program: the top-level name of every module loaded (the part before the first dot),
compared whole, in a fresh process."""
import json
import subprocess
import sys

import pytest

from port_bench import core

DRY = """
import json, sys
from port_bench.tests.tiny import TINY, dry_run
from port_bench import core, trace
for workload in sorted(TINY):
    for traced in (False, True):
        run, out = dry_run(workload, trace=traced)
        if traced:
            ctx = {"traced": out.traced, "work": out.work}
            [core.metric_reader(m["name"])(ctx) for m in run.per_layer()]
            trace.breakdown(out.traced)
print(json.dumps(sorted({name.split(".", 1)[0] for name in sys.modules})))
"""

REFERENCE = """
import json, sys
import port_bench.reference.model, port_bench.reference.planning
import port_bench.reference.training, port_bench.streams, port_bench.work
print(json.dumps(sorted({name.split(".", 1)[0] for name in sys.modules})))
"""


def top_level_modules(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def dry_modules():
    return top_level_modules(DRY)


def test_the_dry_path_loads_no_jax(dry_modules):
    assert "blackbox_mpc_torch" in dry_modules  # the program ran
    assert not set(dry_modules) & set(core.JAX_MODULES)


def test_the_names_are_compared_whole(dry_modules):
    # The port's name begins with the JAX package's stem; only whole names count.
    assert "blackbox_mpc_tpu" not in dry_modules
    assert "blackbox_mpc_torch" in dry_modules


def test_the_references_load_nothing_of_the_program():
    loaded = top_level_modules(REFERENCE)
    assert "blackbox_mpc_torch" not in loaded
    assert not set(loaded) & set(core.JAX_MODULES)


def test_jax_modules_reads_sys_modules(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "blackbox_mpc_tpu_like", object())
    assert "jaxlib" in core.jax_modules()
    assert "blackbox_mpc_tpu_like" not in core.jax_modules()
