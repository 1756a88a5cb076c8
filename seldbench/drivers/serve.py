"""Serving traffic: a closed loop of one caller, each request a batch of whole
recordings as host float32, answered as numpy event probabilities and DOA
vectors at label rate by the program's `SeldInferencePipeline.__call__`, with the
extractor from `make_extractor` and the model from `build_model`, as
`cli.predict` builds them.

The mix states the pool: `pool` requests, each `clips` recordings of
`clip_seconds`, made at set-up from the seed into plain numpy arrays, as a
decoder hands them over, so that the window stacks nothing. The window serves
them in seeded rounds, each round every pool entry once. After the window each
answer is judged against the plain reference, computed once for each pool entry.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from seldbench import signals, work
from seldbench.reference import crnn as ref_crnn
from seldbench.reference import features as ref_features

REFERENCE_REQUESTS = 4  # requests a block of the reference, to bound its memory


class Cell:
    unit = "request"

    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans):
        self.cfg, self.mix, self.seed, self.device, self.spans = cfg, mix, seed, device, spans
        self.latencies: list[float] = []
        self.served: list[tuple[int, np.ndarray, np.ndarray]] = []

    # ------------------------------------------------------------------
    def setup(self) -> None:
        from salsa_tpu_torch.cli.predict import feature_kwargs
        from salsa_tpu_torch.features.registry import make_extractor
        from salsa_tpu_torch.models.seld import build_model
        from salsa_tpu_torch.pipeline import SeldInferencePipeline
        from salsa_tpu_torch.utils.config import AttrDict

        cfg, dev = AttrDict(self.cfg), self.device
        d = cfg.data
        extractor = make_extractor(cfg.feature_type, d.audio_format, **feature_kwargs(cfg))
        model = build_model(encoder=cfg.model.encoder.to_dict(),
                            decoder=cfg.model.decoder.to_dict(), n_classes=d.n_classes,
                            output_format=d.get("output_format", "reg_xyz"))
        self.weights = signals.weights(model, signals.sub_seed(self.seed, 0), dev)
        self.mean, self.std = signals.scaler(signals.sub_seed(self.seed, 1),
                                             extractor.n_features, dev)
        self.ratio = model.time_downsample_ratio * d.label_rate / (d.fs / d.hop_len)
        self.pipe = SeldInferencePipeline(
            extractor, model, self.weights, (self.mean.cpu().numpy(), self.std.cpu().numpy()),
            self.ratio, d.n_classes, d.get("output_format", "reg_xyz"), device=dev)
        self.n_features = extractor.n_features

        shape = (self.mix["clips"], 4, int(round(self.mix["clip_seconds"] * d.fs)))
        self.pool = []
        for i in range(self.mix["pool"]):
            g = torch.Generator(device=dev).manual_seed(signals.sub_seed(self.seed, 2, i))
            waves = np.empty(shape, np.float32)
            torch.from_numpy(waves).copy_(signals.clips(g, shape[0], shape[2], d.fs,
                                                        d.audio_format, dev))
            self.pool.append(waves)
        self._rng = np.random.default_rng(signals.sub_seed(self.seed, 3))
        self._round: list[int] = []
        for _ in range(2):  # the one shape the window serves
            self.pipe(self.pool[0])
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def instrument(self) -> None:
        self.pipe.extractor = self.spans.wrap("features", self.pipe.extractor)
        self.spans.hook("crnn", self.pipe.model)

    def _next_index(self) -> int:
        if not self._round:
            self._round = list(self._rng.permutation(len(self.pool)))
        return int(self._round.pop())

    def timed(self) -> None:
        i = self._next_index()
        t0 = time.perf_counter()
        event_prob, doa = self.pipe(self.pool[i])
        self.latencies.append(time.perf_counter() - t0)
        self.served.append((i, event_prob, doa))

    def close(self) -> None:
        """Every answer is already on the host: nothing is pending."""

    # ------------------------------------------------------------------
    def _frames(self, i: int) -> int:
        return 1 + self.pool[i].shape[-1] // self.cfg["data"]["hop_len"]

    def end_to_end(self, window_s: float) -> dict[str, float]:
        fs = self.cfg["data"]["fs"]
        audio_s = sum(self.pool[i].shape[0] * self.pool[i].shape[-1] / fs
                      for i, _, _ in self.served)
        return {"serve_audio_s_per_s": audio_s / window_s,
                "serve_p95_ms": float(np.percentile(self.latencies, 95)) * 1e3}

    def units(self) -> list[dict]:
        """What each timed call did, in order: clips, frames, bytes copied to the
        card and the CRNN's operations."""
        out = []
        for i, _, _ in self.served:
            w = self.pool[i]
            out.append({"clips": w.shape[0], "frames": self._frames(i), "h2d_bytes": w.nbytes,
                        "flops": work.crnn_flops(w.shape[0], self._frames(i),
                                                 self.n_features)["total"]})
        return out

    def free(self) -> None:
        del self.pipe
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def check(self) -> dict[str, float]:
        """The widest gaps between the served answers and the reference's: the
        largest absolute gap of an event probability and of a DOA component over
        every answer, and the largest root-mean-square gap of one answer."""
        p = ref_features.params_of(self.cfg)
        wanted = sorted({i for i, _, _ in self.served})
        n = self.mix["clips"]
        want = {}
        for b0 in range(0, len(wanted), REFERENCE_REQUESTS):
            idx = wanted[b0:b0 + REFERENCE_REQUESTS]
            waves = torch.from_numpy(np.concatenate([self.pool[i] for i in idx])).to(self.device)
            feats = ref_features.features(waves, p)
            feats = torch.cat([(feats[:, :4] - self.mean) / self.std, feats[:, 4:]], dim=1)
            ev, doa = ref_crnn.serve(self.weights, feats, int(round(self.ratio)))
            ev, doa = ev.cpu().numpy(), doa.cpu().numpy()
            for j, i in enumerate(idx):
                want[i] = (ev[j * n:(j + 1) * n], doa[j * n:(j + 1) * n])
        out = {"event_max": 0.0, "doa_max": 0.0, "event_rms": 0.0, "doa_rms": 0.0}
        for i, ev, doa in self.served:
            for key, got, ref in (("event", ev, want[i][0]), ("doa", doa, want[i][1])):
                if got.shape != ref.shape or not np.isfinite(got).all():
                    return {k: float("inf") for k in out}
                gap = np.abs(got.astype(np.float64) - ref)
                out[f"{key}_max"] = max(out[f"{key}_max"], float(gap.max()))
                out[f"{key}_rms"] = max(out[f"{key}_rms"], float(np.sqrt(np.mean(gap ** 2))))
        return out
