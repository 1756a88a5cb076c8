"""The control on the card: the program with its TF32 path switched on (PyTorch's
default for cuDNN), compared with the float32 reference, reads above a limit in
every cell, while the same cells in float32 read within them. At the tiny sizes;
the readings at the cells' own sizes come from `seldbench.calibrate`."""
from __future__ import annotations

import contextlib

import pytest
import torch

from seldbench import calibrate
from seldbench.manifest import Manifest


@pytest.mark.card
@pytest.mark.parametrize("cell", ["salsa_foa.serve", "salsa_lite_mic.serve", "salsa_foa.train"])
def test_tf32_control_is_not_correct(tiny_root, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 exists only there")
    m = Manifest(tiny_root)
    entry = m.workload(cell)
    limits = {k: v for k, v in m.limits(entry).items() if isinstance(v, dict)}
    dev = torch.device("cuda", 0)
    sound = calibrate.reading(m, entry, 2**32 + 21, 0.5, dev, contextlib.nullcontext)
    control = calibrate.reading(m, entry, 2**32 + 21, 0.5, dev, lambda: calibrate.tf32(True))
    assert all(sound[k] <= limits[k]["limit"] for k in limits), sound
    assert any(control[k] > limits[k]["limit"] for k in limits), control
