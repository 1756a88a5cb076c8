"""Training traffic: `SeldTrainer.train_step` with `training.from_wav`, batches of
the config's `train_batch_size` chunks back to back, drawn from a seeded
permutation of every chunk of the resident split, so no two rows of a run repeat
until the split is spent.

The mix states the split: `clips` recordings of `clip_seconds`, made from the
seed on the card and held by the trainer as int16 (`wav_dtype`), with 2-6 seeded
events a clip as labels; the chunk and label tables are the recipe's (chunks of
`train_chunk_len_s`, hop `train_chunk_hop_len_s`). Set-up builds the trainer,
loads the seeded weights into it and drives it through its first
`checked_steps` steps by the window's own call; the window continues from there.

The check follows those steps in the plain reference: it gathers the same chunks
from the resident int16 clips, works out each clip's whole SALSA map (the
tracker from the clip's first frame, the covariance context wrapped), slices,
normalises, runs the training-mode CRNN with the same dropout draws (the
trainer's per-step seeds, `step_seed`), the SELD loss, autograd and Adam with
the recipe's schedule, and compares the losses, the first gradient as Adam's
first moment holds it and each leaf's change after the checked steps.
"""
from __future__ import annotations

import numpy as np
import torch

from seldbench import signals, work
from seldbench.reference import crnn as ref_crnn
from seldbench.reference import features as ref_features
from seldbench.reference import spatial as ref_spatial

REFERENCE_CLIPS = 16  # clips a block of the reference's spatial stage, to bound its memory


def step_seed(seed: int, step: int, stream: int) -> int:
    """The trainer's documented per-step seed: (run seed, optimizer count before
    the step, stream; dropout is stream 0) through numpy's SeedSequence."""
    return int(np.random.SeedSequence([seed, step, stream]).generate_state(1, np.uint64)[0])


def chunk_starts(n_units: int, chunk_len: int, hop: int) -> list[int]:
    """Chunk starts inside a clip, a trailing chunk where the hop leaves a rest."""
    starts = list(range(0, n_units - chunk_len + 1, hop))
    if (n_units - chunk_len) % hop:
        starts.append(n_units - chunk_len)
    return starts


class Geometry:
    """The recipe's chunking of clips of `n_samples` samples."""

    def __init__(self, d: dict, n_samples: int):
        fps = d["fs"] // d["hop_len"]
        self.upsample = fps // d["label_rate"]
        self.chunk_len = int(d["train_chunk_len_s"] * fps)
        self.chunk_hop = int(d["train_chunk_hop_len_s"] * fps)
        self.label_len = self.chunk_len // self.upsample
        self.label_hop = self.chunk_hop // self.upsample
        self.pad = d["n_fft"] // 2
        self.n_full = 1 + n_samples // d["hop_len"]
        max_labels = int(d.get("max_file_len_s", 60) * d["label_rate"])
        frames = min(self.n_full, max_labels * self.upsample)
        self.n_frames = frames - frames % self.upsample
        self.n_labels = self.n_frames // self.upsample
        self.starts = chunk_starts(self.n_frames, self.chunk_len, self.chunk_hop)
        self.label_starts = chunk_starts(self.n_labels, self.label_len, self.label_hop)


def labels(rng: np.random.Generator, n_clips: int, n_labels: int, n_classes: int,
           label_rate: int):
    """Seeded event labels: 2-6 events a clip, each a class, an onset, 1-5 s and a
    fixed azimuth and elevation. Returns sed (n_clips * n_labels, n) and doa
    (n_clips * n_labels, 3n)."""
    sed = np.zeros((n_clips, n_labels, n_classes), np.float32)
    azi = np.zeros_like(sed)
    ele = np.zeros_like(sed)
    for c in range(n_clips):
        for _ in range(int(rng.integers(2, 7))):
            k = int(rng.integers(n_classes))
            on = int(rng.integers(n_labels))
            off = min(n_labels, on + int(rng.integers(1, 6) * label_rate))
            sed[c, on:off, k] = 1.0
            azi[c, on:off, k] = np.deg2rad(rng.uniform(-180, 180))
            ele[c, on:off, k] = np.deg2rad(rng.uniform(-45, 45))
    doa = np.concatenate([np.cos(azi) * np.cos(ele), np.sin(azi) * np.cos(ele), np.sin(ele)],
                         axis=-1) * np.concatenate([sed] * 3, axis=-1)
    return sed.reshape(-1, n_classes), doa.reshape(-1, 3 * n_classes).astype(np.float32)


class Cell:
    unit = "step"

    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans):
        self.cfg, self.mix, self.seed, self.device, self.spans = cfg, mix, seed, device, spans
        self.steps = 0

    # ------------------------------------------------------------------
    def _split(self):
        """The resident split: int16 clips made on the card in blocks, kept on the
        host (pinned where there is a card) as `WavSplitData` holds them."""
        from salsa_tpu_torch.data.wav_database import WavSplitData

        d, mix, dev = self.cfg["data"], self.mix, self.device
        n_clips, n = mix["clips"], int(round(mix["clip_seconds"] * d["fs"]))
        geo = self.geo = Geometry(d, n)
        s_pad = n + 2 * geo.pad
        waves = torch.empty((n_clips, 4, s_pad), dtype=torch.int16,
                            pin_memory=dev.type == "cuda")
        g = torch.Generator(device=dev).manual_seed(signals.sub_seed(self.seed, 2))
        for c0 in range(0, n_clips, 16):
            k = min(16, n_clips - c0)
            x = ref_features.center_pad(signals.clips(g, k, n, d["fs"], d["audio_format"], dev),
                                        d["n_fft"])
            waves[c0:c0 + k] = torch.round(x * 32768.0).clamp(-32768, 32767).to(torch.int16).cpu()
        self.waves = waves.numpy()
        rng = np.random.default_rng(signals.sub_seed(self.seed, 4))
        self.sed, self.doa = labels(rng, n_clips, geo.n_labels, d["n_classes"], d["label_rate"])
        k = len(geo.starts)
        self.clip_of_chunk = np.repeat(np.arange(n_clips), k).astype(np.int32)
        self.within = np.tile(np.asarray(geo.starts, np.int32), n_clips)
        self.label_rows = (np.repeat(np.arange(n_clips), k) * geo.n_labels
                           + np.tile(np.asarray(geo.label_starts), n_clips)).astype(np.int64)
        names = [f"clip{c:04d}" for c in range(n_clips)]
        return WavSplitData(
            features=np.zeros((7, 0, ref_features.params_of(self.cfg).n_features), np.float32),
            sed_targets=self.sed, doa_targets=self.doa,
            feature_chunk_starts=(self.clip_of_chunk.astype(np.int64) * geo.n_frames
                                  + self.within),
            label_chunk_starts=self.label_rows, clip_names=[names[c] for c in self.clip_of_chunk],
            feature_chunk_len=geo.chunk_len, feature_chunk_hop=geo.chunk_hop,
            label_chunk_len=geo.label_len, label_chunk_hop=geo.label_hop, chunks_per_clip=k,
            unique_clip_names=names, clip_chunk_counts=np.full(n_clips, k, np.int64),
            clip_label_frames=np.full(n_clips, geo.n_labels, np.int64), waves=self.waves,
            wav_scale=1.0 / 32768.0, wav_pad=geo.pad, clip_of_chunk=self.clip_of_chunk,
            within_clip_start=self.within,
            clip_full_frames=np.full(n_clips, geo.n_full, np.int32),
            clip_trimmed_frames=np.full(n_clips, geo.n_frames, np.int32),
            clip_wavs=[self.waves[c, :, geo.pad:geo.pad + n] for c in range(n_clips)])

    def setup(self) -> None:
        from salsa_tpu_torch.models.seld import build_model
        from salsa_tpu_torch.train.trainer import SeldTrainer
        from salsa_tpu_torch.utils.config import AttrDict

        cfg, dev = AttrDict(self.cfg), self.device
        d = cfg.data
        split = self._split()
        model = build_model(encoder=cfg.model.encoder.to_dict(),
                            decoder=cfg.model.decoder.to_dict(), n_classes=d.n_classes,
                            output_format=d.get("output_format", "reg_xyz"))
        self.param_names = [n for n, _ in model.named_parameters()]
        self.weights = signals.weights(model, signals.sub_seed(self.seed, 0), dev)
        self.mean, self.std = signals.scaler(signals.sub_seed(self.seed, 1),
                                             split.features.shape[2], dev)
        self.train_seed = signals.sub_seed(self.seed, 5)
        self.trainer = tr = SeldTrainer(model, cfg, split, None, None, "", seed=self.train_seed,
                                        scaler=(self.mean.cpu().numpy(), self.std.cpu().numpy()),
                                        device=dev)
        tr.model.load_state_dict(self.weights)
        self.batch = cfg.training.train_batch_size
        self.total_steps = tr.steps_per_epoch * tr.max_epochs
        self._rng = np.random.default_rng(signals.sub_seed(self.seed, 3))
        self._order = self._rng.permutation(len(split))
        self._next = 0

        params = dict(tr.model.named_parameters())
        self.losses = []
        for s in range(self.mix["checked_steps"]):
            self.losses.append(tr.train_step(self._take())["loss"])
            if s == 0:  # Adam's first moment after one step is (1 - b1) g
                b1 = float(tr.optimizer.b1)
                moments = tr.optimizer.optimizer.state
                self.grads = {n: moments.get(p, {}).get("exp_avg", torch.zeros_like(p)).detach()
                              / (1 - b1) for n, p in params.items()}
        self.after = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
        self.losses = [float(x) for x in self.losses]
        self.checked_ids = self._order[:self.mix["checked_steps"] * self.batch]

    def instrument(self) -> None:
        tr = self.trainer
        tr.batch = self.spans.wrap("batch", tr.batch)
        tr.forward_backward = self.spans.wrap("forward_backward", tr.forward_backward)

    def _take(self) -> np.ndarray:
        if self._next + self.batch > len(self._order):
            self._order, self._next = self._rng.permutation(len(self._order)), 0
        ids = self._order[self._next:self._next + self.batch]
        self._next += self.batch
        return ids

    def timed(self) -> None:
        self.trainer.train_step(self._take())
        self.steps += 1

    def close(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------------
    def end_to_end(self, window_s: float) -> dict[str, float]:
        return {"train_audio_s_per_s":
                self.steps * self.batch * self.cfg["data"]["train_chunk_len_s"] / window_s}

    def units(self) -> list[dict]:
        f = work.crnn_flops(self.batch, self.geo.chunk_len,
                            ref_features.params_of(self.cfg).n_features)["total"]
        return [{"chunks": self.batch, "flops": 3 * f}] * self.steps

    def free(self) -> None:
        del self.trainer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def reference_batches(self):
        """The checked steps' (features, sed, doa), from the resident int16 clips:
        whole-clip maps (one tracker pass over every clip involved, the spatial
        stage a block of clips at a time), sliced and normalised."""
        p, geo, dev = ref_features.params_of(self.cfg), self.geo, self.device
        ids = self.checked_ids
        clips = sorted({int(self.clip_of_chunk[i]) for i in ids})
        specs, bands = {}, []
        for c0 in range(0, len(clips), REFERENCE_CLIPS):
            cs = clips[c0:c0 + REFERENCE_CLIPS]
            x = torch.from_numpy(self.waves[cs]).to(dev).float() * (1.0 / 32768.0)
            re, im = ref_features.stft_of_padded(x, p.n_fft, p.hop)
            spec = ref_features.log_spectrogram(re, im, p)
            bands.append(ref_features.band(re, im, p))
            for j, c in enumerate(cs):
                specs[c] = spec[j]
        mask = ref_spatial.tracker_mask(torch.cat([b[0][:, 0] for b in bands]),
                                        torch.cat([b[1][:, 0] for b in bands]), p.n_hop,
                                        geo.n_full)
        maps, m0 = {}, 0
        for c0, (xr, xi) in zip(range(0, len(clips), REFERENCE_CLIPS), bands):
            cs = clips[c0:c0 + REFERENCE_CLIPS]
            eig = ref_features.spatial_map(xr, xi, mask[m0:m0 + len(cs)], p)
            m0 += len(cs)
            for j, c in enumerate(cs):
                maps[c] = torch.cat([specs[c], eig[j]], dim=0)
        x = torch.stack([maps[int(self.clip_of_chunk[i])][:, self.within[i]:self.within[i]
                                                          + geo.chunk_len] for i in ids])
        x = torch.cat([(x[:, :4] - self.mean) / self.std, x[:, 4:]], dim=1)
        rows = self.label_rows[ids][:, None] + np.arange(geo.label_len)
        sed = torch.from_numpy(self.sed[rows]).to(dev)
        doa = torch.from_numpy(self.doa[rows]).to(dev)
        return x.split(self.batch), sed.split(self.batch), doa.split(self.batch)

    def reference_steps(self):
        """Losses, the first step's gradients and the state after the checked
        steps, in the plain reference from the seeded weights."""
        t, d, dev = self.cfg["training"], self.cfg["data"], self.device
        xs, seds, doas = self.reference_batches()
        state = {k: v.clone() for k, v in self.weights.items()}
        m = {n: torch.zeros_like(state[n]) for n in self.param_names}
        v = {n: torch.zeros_like(state[n]) for n in self.param_names}
        lr_at, b1_at = schedules(self.total_steps, t["lr_scheduler"])
        losses, first = [], None
        w_sed, w_doa = t.get("loss_weight", (0.3, 0.7))
        n = d["n_classes"]
        for s, (x, sed, doa) in enumerate(zip(xs, seds, doas)):
            g = torch.Generator(device=dev).manual_seed(step_seed(self.train_seed, s, 0))
            leaves = {k: state[k].clone().requires_grad_(True) for k in self.param_names}
            fw = ref_crnn.Forward({**state, **leaves},
                                  lambda shape, g=g: torch.rand(shape, generator=g, device=dev))
            ev, dd = fw(x)
            ratio = self.geo.label_len // ev.shape[1]
            ev, dd = ref_crnn.index_repeat(ev, ratio), ref_crnn.index_repeat(dd, ratio)
            bce = (torch.clamp(ev, min=0) - ev * sed + torch.log1p(torch.exp(-ev.abs()))).mean()
            mass = torch.clamp(sed.sum(), min=1e-8)
            mae = sum((torch.abs(dd[..., i * n:(i + 1) * n] - doa[..., i * n:(i + 1) * n])
                       * sed).sum() / mass for i in range(3))
            loss = w_sed * bce + w_doa * mae
            grads = dict(zip(self.param_names,
                             torch.autograd.grad(loss, [leaves[k] for k in self.param_names])))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: gr.detach() for k, gr in grads.items()}
            with torch.no_grad():
                state.update(fw.stats)
                lr, b1 = lr_at(s), b1_at(s)
                for k in self.param_names:
                    m[k] = b1 * m[k] + (1 - b1) * grads[k]
                    v[k] = 0.999 * v[k] + 0.001 * grads[k] * grads[k]
                    denom = v[k].sqrt() / np.sqrt(1 - 0.999 ** (s + 1)) + 1e-8
                    state[k] = state[k] - (lr / (1 - b1 ** (s + 1))) * m[k] / denom
        return losses, first, state

    def check(self) -> dict[str, float]:
        """loss_gap: the widest relative gap of a checked step's loss; grad_gap and
        change_gap: over the leaves, the widest gap between the program's and the
        reference's norm of the first gradient and of the change over the checked
        steps, against the larger of that leaf's reference norm and the median
        leaf's. The change leaves out parameters whose reference gradient is under
        a thousandth of the median leaf's, which only round-off moves, and takes
        the BatchNorm running statistics as leaves too."""
        losses, first, state = self.reference_steps()
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(self.losses, losses))
        if not np.isfinite(loss_gap):
            return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                    "change_gap": float("inf")}
        g_ref = {k: float(first[k].norm()) for k in self.param_names}
        g_got = {k: float(self.grads[k].norm()) for k in self.param_names}
        med_g = float(np.median(list(g_ref.values())))
        grad_gap = max(abs(g_got[k] - g_ref[k]) / max(g_ref[k], med_g) for k in g_ref)
        kept = [k for k in self.param_names if g_ref[k] >= 1e-3 * med_g]
        kept += [k for k in state if k.endswith(("running_mean", "running_var"))]
        d_ref = {k: float((state[k] - self.weights[k]).norm()) for k in kept}
        d_got = {k: float((self.after[k] - self.weights[k]).norm()) for k in kept}
        med_d = float(np.median(list(d_ref.values())))
        change_gap = max(abs(d_got[k] - d_ref[k]) / max(d_ref[k], med_d) for k in kept)
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def schedules(total_steps: int, sched: dict):
    """The recipe's piecewise-linear lr and beta1 over milestone fractions of the
    run's steps, rounded to float32 as the optimizer receives them."""
    xs = [m * total_steps for m in sched["milestones"]]

    def at(values):
        return lambda step: float(np.float32(np.interp(step, xs, values)))

    return at(sched["lrs"]), at(sched["moms"])
