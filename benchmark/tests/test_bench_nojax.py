"""Nothing the harness runs loads JAX or the JAX package: compared by the
whole top-level module name, since the port's name begins with the JAX
package's. The probe loads every metric reader and every problem kind, the
committed ones and the tests' fixture."""
import os
import subprocess
import sys

from benchlib import cell
from conftest import BENCH, FIXTURES, ROOT

PROBE = r"""
import sys, glob, os, importlib.util
sys.path[:0] = [{root!r}, {bench!r}]
import run
import control
from benchlib import (cell, dotmark, manifest, pool, reference, roofline,
                      trace, traffic)
for path in glob.glob(os.path.join({bench!r}, "metrics", "*.py")):
    manifest.reader(os.path.basename(path)[:-3], {bench!r})
kinds = 0
for where in ({bench!r}, {fixtures!r}):
    for path in glob.glob(os.path.join(where, "problems", "*.py")):
        name = os.path.basename(path)[:-3]
        manifest.problem({{"problem": {{"kind": name}}}}, where)
        kinds += 1
print("KINDS", kinds)
import dotsocp_tpu_torch
from dotsocp_tpu_torch.multilevel.solve import solve_dot
print("FOUND", cell.forbidden_modules())
"""


def test_fresh_process_loads_no_jax():
    code = PROBE.format(root=ROOT, bench=BENCH, fixtures=FIXTURES)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FOUND []" in out.stdout, out.stdout
    assert "KINDS 0" not in out.stdout, out.stdout


def test_names_are_compared_whole():
    assert cell.forbidden_modules(["dotsocp_tpu_torch", "jax_helpers",
                                   "dotsocp_tpu_torch.ops", "flaxen"]) == []
    assert cell.forbidden_modules(["dotsocp_tpu.ops.poisson", "jaxlib.xla",
                                   "flax", "jax"]) == \
        ["dotsocp_tpu", "flax", "jax", "jaxlib"]
