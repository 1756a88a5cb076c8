"""The plain reference against the port's CPU path (its kernels' plain versions)
at small sizes: SALSA FOA and SALSA-Lite MIC features, the CRNN, and the checked
training steps."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from seldbench import signals, tracing
from seldbench.drivers import train
from seldbench.manifest import Manifest
from seldbench.reference import crnn as ref_crnn
from seldbench.reference import features as ref_features
from seldbench.tests.conftest import REPO


@pytest.mark.parametrize("config", ["salsa_foa", "salsa_lite_mic"])
def test_features_match_the_port(config):
    from salsa_tpu_torch.features.registry import make_extractor

    cfg = _config(config)
    d = cfg["data"]
    waves = signals.clips(torch.Generator().manual_seed(7), 2, 24000, d["fs"], d["audio_format"],
                          "cpu")
    got = make_extractor(cfg["feature_type"], d["audio_format"], fs=d["fs"], n_fft=d["n_fft"],
                         hop_length=d["hop_len"])(waves)
    want = ref_features.features(waves, ref_features.params_of(cfg))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
    assert (want[:, 4:] != 0).float().mean() > 0.05  # the spatial channels are not empty


def _config(name):
    m = Manifest(REPO)
    return m.config({"config": name})


def test_crnn_matches_the_port_in_eval_and_training_mode():
    from salsa_tpu_torch.models.layers import Dropout
    from salsa_tpu_torch.models.seld import build_model

    cfg = _config("salsa_foa")
    model = build_model(encoder=cfg["model"]["encoder"], decoder=cfg["model"]["decoder"],
                        n_classes=12)
    w = signals.weights(model, 3, "cpu")
    model.load_state_dict(w)
    x = torch.randn(2, 7, 64, 200, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = model.eval()(x)
        ev, doa = ref_crnn.Forward(w)(x)
    torch.testing.assert_close(out["event_frame_logit"], ev, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(out["doa_frame_output"], doa, atol=2e-5, rtol=1e-4)

    g = torch.Generator().manual_seed(9)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = g
    out = model.train()(x)
    g2 = torch.Generator().manual_seed(9)
    fw = ref_crnn.Forward(dict(w), lambda shape: torch.rand(shape, generator=g2))
    ev, doa = fw(x)
    torch.testing.assert_close(out["event_frame_logit"], ev, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(out["doa_frame_output"], doa, atol=2e-5, rtol=1e-4)
    sd = model.state_dict()
    for k, v in fw.stats.items():
        torch.testing.assert_close(sd[k], v, atol=1e-6, rtol=1e-5)


def test_checked_training_steps_match_the_port(tiny_root):
    m = Manifest(tiny_root)
    cell = m.workload("salsa_foa.train")
    c = train.Cell(m.config(cell), m.traffic(cell), 2**32 + 5, torch.device("cpu"),
                   tracing.Spans(False))
    c.setup()
    xs, seds, doas = c.reference_batches()
    x, sed, doa = c.trainer.batch(c.checked_ids[:c.batch])
    torch.testing.assert_close(x, xs[0], atol=2e-5, rtol=1e-5)
    assert torch.equal(sed, seds[0]) and torch.equal(doa, doas[0])
    losses, first, _ = c.reference_steps()
    assert losses[0] == pytest.approx(c.losses[0], rel=1e-5)
    numbers = c.check()
    assert numbers["grad_gap"] < 1e-2 and numbers["loss_gap"] < 1e-2, numbers
    assert np.isfinite(list(numbers.values())).all()
