"""What a run loads: no module whose top-level name, compared whole, is JAX's
(`jax`, `jaxlib`, `flax`, `optax`, `orbax`) or the JAX package's (`salsa_tpu`),
and the reference loads nothing of the program."""
from __future__ import annotations

import json
import subprocess
import sys

from seldbench.tests.conftest import REPO

RUN_TINY_CELLS = """
import json, sys, torch
from pathlib import Path
from seldbench import run
from seldbench.manifest import Manifest
m = Manifest(Path(sys.argv[1]))
for name in ("salsa_foa.serve", "salsa_lite_mic.serve", "salsa_foa.train"):
    run.run_cell(m, name, 2**32 + 3, 0.1, False, torch.device("cpu"))
    for metric in m.per_layer(m.workload(name)):
        m.reader(metric["name"])
import seldbench.calibrate, seldbench.tracing
print(json.dumps(run.forbidden_modules()))
"""

REFERENCE_ONLY = """
import json, sys
import seldbench.reference.crnn, seldbench.reference.features, seldbench.reference.spatial
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _python(code, *args):
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_of_each_cell_loads_nothing_of_jax(tiny_root):
    assert _python(RUN_TINY_CELLS, str(tiny_root)) == []


def test_the_reference_loads_nothing_of_the_program_or_jax():
    names = set(_python(REFERENCE_ONLY))
    assert not names & {"salsa_tpu_torch", "jax", "jaxlib", "flax", "optax", "orbax",
                        "salsa_tpu"}
