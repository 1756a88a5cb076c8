"""Carry trained `salsa_tpu` (flax) weights into the port."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def load_flax_variables(model: nn.Module, params: dict, batch_stats: dict) -> nn.Module:
    """Load flax trees (nested dicts of numpy arrays) into a port model, strictly.

    The mapping is `salsa_tpu.interop.torch_export.flax_to_torch_state_dict` (pure
    numpy), imported here because only a host with flax parameters calls this; the
    port's module names are the reference torch names it emits.
    """
    from salsa_tpu.interop.torch_export import flax_to_torch_state_dict

    sd = flax_to_torch_state_dict(params, batch_stats)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                          strict=True)
    return model
