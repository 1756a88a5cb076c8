"""The full-width SALSA-FOA serving configuration (`configs/seld.yml`, the
reference headline recipe) as Python dicts, so a host without yaml can build it.
`MODEL` and `DATA` equal that file's `model` and `data` blocks."""
from __future__ import annotations

DATA = {
    "fs": 24000,
    "n_fft": 512,
    "hop_len": 300,
    "audio_format": "foa",
    "label_rate": 10,
    "train_chunk_len_s": 8,
    "train_chunk_hop_len_s": 0.5,
    "test_chunk_len_s": 60.0,
    "test_chunk_hop_len_s": 60.1,
    "n_classes": 12,
    "train_fraction": 1.0,
    "val_fraction": 1.0,
    "output_format": "reg_xyz",
}

MODEL = {
    "encoder": {"name": "PannResNet22", "n_input_channels": 7},
    "decoder": {"name": "SeldDecoder", "decoder_type": "bigru", "decoder_size": 256,
                "freq_pool": "avg"},
}

# keyword arguments of models.seld.build_model
SELD_FOA = {**MODEL, "n_classes": DATA["n_classes"], "output_format": DATA["output_format"]}
