"""The yardstick's counts against hand counts and against the model itself."""
from __future__ import annotations

import pytest
import torch
from torch import nn

from seldbench import work


def test_crnn_flops_match_the_hand_count_of_an_8_s_chunk():
    parts = work.crnn_flops(1, 640, 200)
    assert parts["conv"] == pytest.approx(44.74e9, rel=1e-3)
    assert parts["gru"] == pytest.approx(0.19e9, rel=1e-2)
    assert parts["linear"] == pytest.approx(0.04e9, rel=0.1)
    assert parts["total"] == pytest.approx(44.97e9, rel=1e-3)


def test_crnn_flops_match_the_models_layers():
    from salsa_tpu_torch.models.seld import build_model

    model = build_model(encoder={"name": "PannResNet22", "n_input_channels": 7},
                        decoder={"name": "SeldDecoder", "decoder_type": "bigru",
                                 "decoder_size": 256}, n_classes=12).eval()
    counted = []

    def conv(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        counted.append(2.0 * m.in_channels * m.out_channels * k * out[0].numel()
                       / m.out_channels * out.shape[0])

    def linear(m, inp, out):
        counted.append(2.0 * m.in_features * m.out_features * out.numel() / m.out_features)

    def gru(m, inp, out):
        b, t, _ = out[0].shape
        dirs = 2 if m.bidirectional else 1
        for layer in range(m.num_layers):
            n_in = m.input_size if layer == 0 else m.hidden_size * dirs
            counted.append(dirs * 2.0 * 3 * m.hidden_size * (n_in + m.hidden_size) * t * b)

    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            mod.register_forward_hook(conv)
        elif isinstance(mod, nn.Linear):
            mod.register_forward_hook(linear)
        elif isinstance(mod, nn.GRU):
            mod.register_forward_hook(gru)
    with torch.no_grad():
        model(torch.zeros(2, 7, 96, 200))
    assert sum(counted) == pytest.approx(work.crnn_flops(2, 96, 200)["total"], rel=1e-9)


def test_kernel_bounds_at_the_serving_shape():
    ms, bound = work.k1_least_ms(4, 191, 4801, "foa")
    assert bound == "operations" and ms == pytest.approx(0.1156, rel=1e-3)
    ms, bound = work.k2_least_ms(4, 191, 4801)
    assert bound == "bytes" and ms == pytest.approx(0.00987, rel=1e-3)
