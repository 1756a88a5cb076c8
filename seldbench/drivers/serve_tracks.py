"""Serving traffic for a track-wise model (EINV2, the `tracks` output format): the
`serve` driver's closed loop, pool and rounds, answered as numpy event
probabilities (B, T, 3, n) and DOA vectors (B, T, 3, 3) at label rate. Three
things differ from `serve.Cell`:

* the weights (`weights`): `signals.weights` takes every `weight` entry for a conv
  or linear kernel, which LayerNorm's 1-D scales are not, and would draw the
  cross-stitch parameters within 0.05, so that each of the three units would
  scale both branches down ~20x and eval-mode BatchNorm would leave little but
  its own shift; the same seeded uniform call is mapped with LayerNorm scales in
  [0.8, 1.2] and shifts within 0.1, the cross-stitch parameters in [0.1, 0.9),
  and the convolutions within He's limit sqrt(6 / fan_in), the scale a ReLU
  network's convolutions keep. Under Xavier's limit each conv halves or more the
  variance that reaches the next ReLU, and BatchNorm's fixed statistics do not
  restore it: after the eight convs of a branch the maps' spread over frames is
  under a tenth of their mean, and the answers to two requests differ by ~0.007
  (event) and ~0.016 (DOA) against ~0.03 and ~0.07 under He's (CPU, 2 clips of
  10 s);
* the operations a request (`units`), EINV2's (`work_einv2.einv2_flops`);
* the comparison (`check`), with `reference/einv2.py`, one request a block of
  the reference (a 4 x 60 s request's first maps are 0.98 GB a tensor).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from seldbench import signals, work_einv2
from seldbench.drivers import serve
from seldbench.reference import einv2 as ref_einv2
from seldbench.reference import features as ref_features


@torch.no_grad()
def weights(model: nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded float32 weights for every entry of `model`'s state_dict, drawn in
    one call on `device` as `signals.weights` draws them: LayerNorm scales in
    [0.8, 1.2] and shifts within 0.1, cross-stitch parameters (`alpha`) in
    [0.1, 0.9), convolutions within sqrt(6 / fan_in), every other entry as
    `signals._affine` maps it."""
    sd = model.state_dict()
    floats = [k for k, v in sd.items() if v.is_floating_point()]
    u = torch.rand(sum(sd[k].numel() for k in floats),
                   generator=torch.Generator(device=device).manual_seed(seed), device=device)
    out, offset = {}, 0
    for k, v in sd.items():
        if not v.is_floating_point():
            out[k] = torch.zeros_like(v, device=device)
            continue
        x = u[offset:offset + v.numel()].view(v.shape)
        offset += v.numel()
        owner, leaf = k.rsplit(".", 1)
        module = model.get_submodule(owner)
        if isinstance(module, nn.LayerNorm):
            out[k] = 0.8 + 0.4 * x if leaf == "weight" else -0.1 + 0.2 * x
        elif isinstance(module, nn.Conv2d):
            lim = float(np.sqrt(6.0 / v[0].numel()))
            out[k] = lim * (2.0 * x - 1.0)
        elif leaf == "alpha":
            out[k] = 0.1 + 0.8 * x
        else:
            out[k] = signals._affine(k, v, x, model)
    return out


class Cell(serve.Cell):
    def setup(self) -> None:
        """`serve.Cell.setup` with this module's `weights` in place of
        `signals.weights`, which it calls."""
        drawn = signals.weights
        signals.weights = weights
        try:
            super().setup()
        finally:
            signals.weights = drawn

    def units(self) -> list[dict]:
        """What each timed call did, in order: clips, frames, bytes copied to the
        card and EINV2's operations."""
        d = self.cfg["data"]
        out = []
        for i, _, _ in self.served:
            w = self.pool[i]
            out.append({"clips": w.shape[0], "frames": self._frames(i), "h2d_bytes": w.nbytes,
                        "flops": work_einv2.einv2_flops(w.shape[0], self._frames(i),
                                                        self.n_features,
                                                        n_classes=d["n_classes"])["total"]})
        return out

    def check(self) -> dict[str, float]:
        """The widest gaps between the served answers and the reference's, as
        `serve.Cell.check` takes them, over the track outputs."""
        p = ref_features.params_of(self.cfg)
        stride = int(round(1.0 / self.ratio))
        want = {}
        for i in sorted({i for i, _, _ in self.served}):
            feats = ref_features.features(torch.from_numpy(self.pool[i]).to(self.device), p)
            feats = torch.cat([(feats[:, :4] - self.mean) / self.std, feats[:, 4:]], dim=1)
            ev, doa = ref_einv2.serve(self.weights, feats, stride)
            want[i] = (ev.cpu().numpy(), doa.cpu().numpy())
            del feats, ev, doa
        out = {"event_max": 0.0, "doa_max": 0.0, "event_rms": 0.0, "doa_rms": 0.0}
        for i, ev, doa in self.served:
            for key, got, ref in (("event", ev, want[i][0]), ("doa", doa, want[i][1])):
                if got.shape != ref.shape or not np.isfinite(got).all():
                    return {k: float("inf") for k in out}
                gap = np.abs(got.astype(np.float64) - ref)
                out[f"{key}_max"] = max(out[f"{key}_max"], float(gap.max()))
                out[f"{key}_rms"] = max(out[f"{key}_rms"], float(np.sqrt(np.mean(gap ** 2))))
        return out
