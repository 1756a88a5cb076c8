"""End-to-end SELD serving (counterpart of `salsa_tpu.pipeline`): raw multichannel
waves -> features of any type of the registry (SALSA: K2 tracker + K1 spatial
kernel on CUDA) -> scaler -> CRNN -> index-repeat to label rate -> event
probabilities + DOA xyz, all on one device, numpy in and out."""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from salsa_tpu_torch.features.registry import FeatureExtractor
from salsa_tpu_torch.interop import load_flax_variables
from salsa_tpu_torch.models.seld import interpolate_index_repeat
from salsa_tpu_torch.staging import PinnedRing, upload
from salsa_tpu_torch.utils.profiling import span


def load_weights(model: nn.Module, state_dict: Mapping | None) -> nn.Module:
    """Load a torch state_dict (strictly) or flax variables {'params',
    'batch_stats'} (through `interop`) into `model`; None keeps its weights."""
    if state_dict is not None and "params" in state_dict:
        load_flax_variables(model, state_dict["params"], state_dict["batch_stats"])
    elif state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


def normalize(feat: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Scale the leading mean.shape[0] channels of (B, C, T, F) features (the
    feature type's n_spec_channels); the others (the SALSA family's spatial
    channels) pass as they are."""
    n_sc = mean.shape[0]
    return torch.cat([(feat[:, :n_sc] - mean) / std, feat[:, n_sc:]], dim=1)


OUTPUT_FORMATS = ("reg_xyz", "accdoa", "tracks")


def heads(event_logit: torch.Tensor, doa: torch.Tensor, interp_ratio: float, n_classes: int,
          output_format: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoder-rate outputs (B, T, n) and (B, T, 3n) -> (event_prob, doa) at label
    rate: sigmoid of the event logits, or for accdoa the norm of each class's
    DOA vector. `tracks` (EINV2): (B, T, K, n) logits and (B, T, K, 3) DOA ->
    sigmoid a track and class, and each track's xyz."""
    event_logit = interpolate_index_repeat(event_logit, interp_ratio)
    doa = interpolate_index_repeat(doa, interp_ratio)
    if output_format == "accdoa":
        n = n_classes
        x, y, z = doa[..., :n], doa[..., n:2 * n], doa[..., 2 * n:]
        return torch.sqrt(x**2 + y**2 + z**2), doa
    return torch.sigmoid(event_logit), doa


class SeldInferencePipeline:
    """waveform (n_ch, n_samples) or batch (B, n_ch, n_samples) -> predictions.

    Args:
        extractor: a FeatureExtractor from `make_extractor`.
        model: a SeldNet.
        state_dict: weights for `model`: a torch state_dict (loaded strictly), flax
            variables {'params', 'batch_stats'} (through `interop`), or None to
            serve the model's current weights.
        scaler: (mean, std) arrays of shape (n_scaler_chan, 1, F); only the leading
            n_scaler_chan feature channels are normalized (4 for the SALSA family,
            all for the classic types).
        interp_ratio: encoder-rate -> label-rate index-repeat factor.
        output_format: 'reg_xyz' and 'accdoa' answer event_prob (B, T, n) and doa
            (B, T, 3n); 'tracks' (EINV2) event_prob (B, T, 3, n) and doa (B, T, 3, 3).
        device: where features and model run; the first CUDA card by default.
            `device="cpu"` runs the kernels' plain versions, for tests.

    On a card each request is uploaded through a ring of pinned host blocks that
    the pipeline keeps across requests (`staging.upload`).
    """

    def __init__(self, extractor: FeatureExtractor, model: nn.Module,
                 state_dict: Mapping | None, scaler, interp_ratio: float, n_classes: int,
                 output_format: str = "reg_xyz", device: torch.device | str = "cuda"):
        if output_format not in OUTPUT_FORMATS:
            raise ValueError(f"unknown output format '{output_format}'")
        self.device = torch.device(device)
        self.extractor = extractor
        self.model = load_weights(model, state_dict).to(self.device).eval()
        mean, std = scaler
        self.mean = torch.as_tensor(np.asarray(mean, np.float32), device=self.device)
        self.std = torch.as_tensor(np.asarray(std, np.float32), device=self.device)
        self.interp_ratio = float(interp_ratio)
        self.n_classes = n_classes
        self.output_format = output_format
        self._ring = PinnedRing()

    def _normalize(self, feat: torch.Tensor) -> torch.Tensor:
        return normalize(feat, self.mean, self.std)

    @torch.inference_mode()
    def forward(self, waves: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, n_ch, n_samples) tensor on `device` -> (event_prob, doa) tensors."""
        with span("serve.features"):
            feat = self.extractor(waves)
        feat = self._normalize(feat)
        with span("serve.model"):
            out = self.model(feat)
        return heads(out["event_frame_logit"], out["doa_frame_output"], self.interp_ratio,
                     self.n_classes, self.output_format)

    @span("serve.request")
    def __call__(self, waves) -> tuple[np.ndarray, np.ndarray]:
        """Returns (event_prob, doa_xyz) at label rate, as numpy arrays."""
        waves = np.asarray(waves, dtype=np.float32)
        squeeze = waves.ndim == 2
        if squeeze:
            waves = waves[None]
        with span("serve.h2d"):
            waves = upload(torch.from_numpy(waves), self.device, self._ring)
        event_prob, doa = self.forward(waves)
        event_prob, doa = event_prob.cpu().numpy(), doa.cpu().numpy()
        if squeeze:
            event_prob, doa = event_prob[0], doa[0]
        return event_prob, doa
