"""SELD trainer, data-parallel over ranks (counterpart of
`salsa_tpu.train.trainer`).

Three ways feed the train step, each a branch of `salsa_tpu`'s trainer:

  * host batches (a feature-store split): `data.dataset.batch_iterator` shuffles
    the epoch, reads each chunk window (preloaded or lazy) and runs the host
    transforms (`data.transforms`) on a prefetch thread; each batch goes to the
    device from pinned memory, non-blocking, while the thread builds the next;
  * `training.device_data`: the split's features and targets go to the device
    once (float32, or bfloat16 with `device_data_dtype`), and each step gathers
    its windows there from the chunks' start frames: the host sends indices;
  * `training.from_wav` (a WavSplitData split): the waveforms stay resident on
    the card with every chunk's table row (clip, start frame, untrimmed frame
    count, valid frames, label start, tracker checkpoint), and each step extracts
    its chunks (`features.chunked`: for SALSA one windowed-DFT matmul, K2 resumed
    from the chunks' tracker checkpoints, K1; for the frame-local types their
    DFT matmuls alone), normalizes the scaler's channels and zeroes the frames
    past each chunk's valid length (after normalization, as the store pads).

Then, in eager PyTorch: with `training.device_augment` (true or "feature"), the
batch is augmented on the device (`train.device_augment`: draws on a CPU
generator; the host transforms are then dropped); the CRNN runs forward in
training mode (flax's BatchNorm update, dropout from an explicit generator), the
outputs are index-repeated to label rate, the SELD loss and backward; one
Adam/AdamW update with the scheduled lr and beta1 (`train.state`). With
`training.remat` the encoder's blocks recompute their activations in the
backward pass (`enable_remat`), and the step is the same step.

Each step's randomness is a pure function of (seed, step), as `salsa_tpu` folds
the step into its key (`jax.random.fold_in`): before every step the dropout and
the augmentation generators are seeded from (seed, optimizer count), each from a
stream of its own. So a run resumed from a checkpoint (`fit(resume_from=...)`:
weights, BatchNorm statistics and Adam's state) takes the steps an uninterrupted
run takes. The host transforms draw from their own generator, as `salsa_tpu`'s.

The epoch order is `np.random.default_rng((seed, epoch))`'s shuffle, as
`salsa_tpu`'s; `training.steps_per_dispatch` only groups steps into dispatches
there and changes nothing here. Validation predicts the val split (from the
store, or extracted once per call of `cli.train` from wavs), writes DCASE CSVs
and scores them. The prediction half (`SeldPredictor`: the eval step,
channel-swap TTA folded into the batch, the validation losses, CSVs and
prediction dumps) is what `cli.infer` runs. Checkpoints are flax msgpack, or
`.orbax` directories under `training.checkpoint_backend: orbax`
(`train.checkpoint`), with the optimizer state in optax's layout, so
`salsa_tpu` restores them.

Data parallelism (`parallel.distributed`: one process a rank, one device each)
keeps `salsa_tpu`'s one-global-batch semantics, so N ranks compute what one
process computes on the whole batch, up to the order of floating-point sums.
Every rank walks the same epoch order and takes its rows of each global batch
(`distributed.local_batch_slice`): the host path reads and transforms only
those rows (`batch_iterator(process_shard=)`), the resident and from-wav paths
gather or extract them (on the from-wav path K1 and K2 run on the rank's rows).
BatchNorm normalizes by the global batch's statistics and dropout and the
device augmentation draw the global batch's masks and keep the rank's rows
(`models.layers`); the losses divide by global denominators (`train.losses`),
and after the backward one flattened all-reduce sums the gradients and the
step's losses, so every rank takes the same Adam step and logs the global
losses. `training.device_data_shard` keeps only a rank's block of the clips on
its device (the store's features re-laid per clip, or the from-wav waveforms),
with `salsa_tpu`'s shard-stratified epoch order: column block r of every batch
holds B / N chunks of rank r's clips, and an unbalanced split caps the epoch's
steps. With one rank it is `device_data` (or plain from-wav), as in `salsa_tpu`.
Validation, CSVs and checkpoints are rank 0's; every rank restores a checkpoint
it resumes from.
"""
from __future__ import annotations

import functools
import os
import shutil
import time
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from salsa_tpu_torch.data.dataset import SeldChunkDataset, batch_iterator, prefetch
from salsa_tpu_torch.data.database import truncate_clips
from salsa_tpu_torch.data.wav_database import WavSplitData, length_groups
from salsa_tpu_torch.features.chunked import make_chunk_extractor, salsa_tracker_checkpoints_batch
from salsa_tpu_torch.features.registry import feature_n_spec_channels
from salsa_tpu_torch.features.salsa import SalsaParams
from salsa_tpu_torch.interop import load_flax_variables, torch_state_dict_to_flax
from salsa_tpu_torch.metrics.scorer import evaluate_submissions
from salsa_tpu_torch.models.layers import (
    BatchNorm2d,
    DoubleConvBlock,
    Dropout,
    ResNetBasicBlock,
    ResNetBottleneckBlock,
)
from salsa_tpu_torch.models.seld import init_train_, interpolate_index_repeat
from salsa_tpu_torch.parallel import distributed, mesh
from salsa_tpu_torch.submission import (
    combine_chunks,
    sed_from_accdoa,
    write_classwise_csv,
    write_trackwise_csv,
)
from salsa_tpu_torch.train import checkpoint as ckpt
from salsa_tpu_torch.train.device_augment import make_device_augment
from salsa_tpu_torch.train.losses import (
    accdoa_loss,
    accdoa_mse,
    bce_with_logits,
    masked_reg_loss,
    seld_loss,
    tpit_loss,
)
from salsa_tpu_torch.train.state import make_optimizer
from salsa_tpu_torch.train.tta import tta_fold
from salsa_tpu_torch.utils.experiments import logger
from salsa_tpu_torch.utils.profiling import span

DROPOUT_STREAM, AUGMENT_STREAM = 0, 1  # the per-step seeds' streams


def step_seed(seed: int, step: int, stream: int) -> int:
    """The seed of a step's generator: a pure function of the run's seed, the
    step (the optimizer's count before it) and the generator's stream."""
    return int(np.random.SeedSequence([seed, step, stream]).generate_state(1, np.uint64)[0])


def resolve_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device; with more than one rank, 'cuda' without an index
    is the rank's card (`distributed.local_device`); a CUDA device on a host without
    one raises."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and distributed.process_count() > 1:
        device = distributed.local_device()
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the trainer runs on the CUDA card by default and this host has "
                           "none (torch.cuda.is_available() is False); pass device='cpu' "
                           "for a CPU run")
    return device


def stratified_order(shard_chunk_ids: list[np.ndarray], batch_size: int,
                     rng: np.random.Generator) -> np.ndarray:
    """`salsa_tpu`'s shard-stratified epoch order over N shards: each shard's chunks
    shuffled by `rng` in shard order, then every batch's column block r filled
    with batch_size / N chunks of shard r, for as many batches as every shard can
    fill."""
    per = batch_size // len(shard_chunk_ids)
    streams = []
    for ids in shard_chunk_ids:
        ids = ids.copy()
        rng.shuffle(ids)
        streams.append(ids)
    steps = min(len(ids) // per for ids in streams)
    order = np.empty((steps, len(streams), per), np.int64)
    for r, ids in enumerate(streams):
        order[:, r] = ids[:steps * per].reshape(steps, per)
    return order.reshape(-1)


REMAT_BLOCKS = (DoubleConvBlock, ResNetBasicBlock, ResNetBottleneckBlock)


def _remat_forward(module: torch.nn.Module, forward, *args):
    """`forward(*args)` under torch.utils.checkpoint in a training forward that
    records gradients: the block keeps its input alone and recomputes its
    activations in the backward pass. The recompute replays the block's dropout
    draws (each explicit generator restored to its state at the block's entry:
    checkpoint preserves torch's default generators only) and moves its BatchNorm
    running statistics once (the recompute's update is undone), so that the step
    equals the plain step."""
    if not (module.training and torch.is_grad_enabled()):
        return forward(*args)
    gens = [m.generator for m in module.modules()
            if isinstance(m, Dropout) and m.generator is not None]
    states = [g.get_state() for g in gens]
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    calls = []

    def run(*a):
        for g, st in zip(gens, states):
            g.set_state(st)
        if not calls:  # the forward pass
            calls.append(1)
            return forward(*a)
        kept = [[b.clone() for b in m.buffers()] for m in bns]
        try:
            return forward(*a)
        finally:  # also where checkpoint stops the recompute early
            with torch.no_grad():
                for m, bufs in zip(bns, kept):
                    for b, k in zip(m.buffers(), bufs):
                        b.copy_(k)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def enable_remat(model: torch.nn.Module) -> int:
    """`training.remat`: every conv block of the encoder (the stem's double conv,
    each residual block) recomputes its activations in the backward pass
    (`_remat_forward`; `salsa_tpu` wraps its model in `jax.checkpoint`). Patches the
    blocks' `forward` on the instance, so parameters and checkpoints keep their
    names. Returns the number of blocks."""
    blocks = [m for m in model.encoder.modules() if isinstance(m, REMAT_BLOCKS)]
    for m in blocks:
        m.forward = functools.partial(_remat_forward, m, m.forward)
    return len(blocks)


class SeldPredictor:
    """The prediction half of the trainer: a model on `device` (eval mode for every
    prediction), the label-rate eval step, the validation losses, and
    `predict_split`, which writes a split's DCASE CSVs and, where asked, its
    per-clip prediction dumps. `cli.infer` predicts through it alone; SeldTrainer
    adds training."""

    def __init__(self, model, cfg, device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_classes = cfg.data.n_classes
        self.output_format = cfg.data.get("output_format", "reg_xyz")
        self.label_rate = cfg.data.get("label_rate", 10)
        self.eval_version = str(cfg.get("eval_version", "2021"))
        self.sed_threshold = cfg.get("sed_threshold", 0.3)
        self.doa_threshold = cfg.get("doa_threshold", 20)
        self.max_label_frames = int(cfg.data.get("max_file_len_s", 60) * self.label_rate)
        self.loss_weight = tuple(cfg.get("training", {}).get("loss_weight", (0.3, 0.7)))
        self.interp_ratio = model.time_downsample_ratio * self.label_rate / (
            cfg.data.fs / cfg.data.hop_len)
        self.model = model.to(self.device)
        self.last_val_losses: dict[str, float] = {}

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def eval_step(self, x: torch.Tensor):
        """(event_prob, doa, event_logit) at label rate, the model in eval mode."""
        self.model.eval()
        out = self.model(x)
        event_logit = interpolate_index_repeat(out["event_frame_logit"], self.interp_ratio)
        doa = interpolate_index_repeat(out["doa_frame_output"], self.interp_ratio)
        if self.output_format == "accdoa":
            return sed_from_accdoa(doa, self.n_classes), doa, event_logit
        return torch.sigmoid(event_logit), doa, event_logit

    def val_losses(self, event_logit, doa_pred, sed_gt, doa_gt, n_real: int):
        """Validation (total, sed, doa) losses with the training formulas:
        prediction frames trimmed to the targets', padded rows past n_real masked
        out of both terms."""
        n = min(event_logit.shape[1], sed_gt.shape[1])
        logit, tgt = event_logit[:, :n], sed_gt[:, :n]
        row = (torch.arange(logit.shape[0], device=logit.device) < n_real).to(logit.dtype)
        if self.output_format == "tracks":
            return tpit_loss(logit, doa_pred, *self.track_targets(tgt, doa_gt),
                             self.loss_weight, row_weights=row)
        mask = tgt * row[:, None, None]
        if self.output_format == "accdoa":
            doa_l = accdoa_mse(doa_pred[:, :n], doa_gt[:, :n], mask, self.n_classes, n_real * n)
            return doa_l, torch.zeros_like(doa_l), doa_l
        sed_l = bce_with_logits(logit, tgt, row_weights=row)
        c = self.n_classes
        doa_l = sum(masked_reg_loss(doa_pred[:, :n, i * c:(i + 1) * c],
                                    doa_gt[:, :n, i * c:(i + 1) * c], mask) for i in range(3))
        total = self.loss_weight[0] * sed_l + self.loss_weight[1] * doa_l
        return total, sed_l, doa_l

    def track_targets(self, sed: torch.Tensor, doa: torch.Tensor):
        """The `tracks` label tables' rows (B, T, K n) and (B, T, 3K) as (B, T, K, n)
        and (B, T, K, 3)."""
        return sed.unflatten(-1, (-1, self.n_classes)), doa.unflatten(-1, (-1, 3))

    def tta_fold(self, n_variants: int, x_shape) -> int:
        """Variants per eval dispatch under `training.tta_elements_per_dispatch`
        (default 2e8 elements, as `salsa_tpu`'s)."""
        budget = float(self.cfg.get("training", {}).get("tta_elements_per_dispatch", 2e8))
        return tta_fold(n_variants, x_shape, budget)

    @torch.inference_mode()
    def eval_tta(self, x: torch.Tensor, tta):
        """(event_prob, doa, identity event_logit, identity doa) of a batch x
        (B, C, T, F) averaged over every variant of `tta` (a ChannelSwapTTA): the
        variants fold into the batch dimension, `tta_fold` of them a dispatch; each
        variant's DOA maps back through the inverse label transform. Event
        probabilities sum in float32 and DOAs in float64 in variant order, as
        `salsa_tpu`'s numpy sums, and the mean is cast back to float32. For accdoa
        the event probability is each variant's norm before the mean."""
        K, B = len(tta), x.shape[0]
        fold = self.tta_fold(K, x.shape)
        ev_acc = doa_acc = id_logit = id_doa = None
        for g in range(0, K, fold):
            ev, dd, logit = self.eval_step(tta.transform_group(x, range(g, g + fold)))
            ev, dd = ev.unflatten(0, (fold, B)), dd.unflatten(0, (fold, B))
            if g == 0:  # variant 0 is the identity: the validation losses' outputs
                id_logit, id_doa = logit.unflatten(0, (fold, B))[0], dd[0]
            for j in range(fold):
                mapped = tta.inverse_doa(dd[j], g + j).double()
                ev_acc = ev[j] if ev_acc is None else ev_acc + ev[j]
                doa_acc = mapped if doa_acc is None else doa_acc + mapped
        return ev_acc / K, (doa_acc / K).float(), id_logit, id_doa

    def predict_split(self, split_data, submission_dir: str, combine_method: str = "mean",
                      tta=None, output_pred_dir: str | None = None) -> list[str]:
        """Predict a val/test split (one chunk batch a call, in clip order) and write
        one submission CSV per clip; returns the CSV names. The mean validation
        losses go to `last_val_losses`.

        With `tta` (a ChannelSwapTTA) each batch's predictions are the mean over
        its symmetry variants (`eval_tta`), the losses the identity variant's.
        With `output_pred_dir` each clip's predictions and ground truth are dumped
        as `<clip>.npz` holding `salsa_tpu`'s four arrays under their names:
        event_frame_pred (1, T, n), doa_frame_pred (1, T, 3n), event_frame_gt and
        doa_frame_gt. `salsa_tpu` writes them to `<clip>.h5`; this host has no
        h5py, so the format changes and nothing else does (`train.ensemble`
        reads both); a `<clip>.h5` there is replaced by the new dump."""
        os.makedirs(submission_dir, exist_ok=True)
        if output_pred_dir:
            os.makedirs(output_pred_dir, exist_ok=True)
        ds = SeldChunkDataset(split_data)
        bs = min(max(split_data.chunks_per_clip, 8), max(1, len(ds)))
        probs, doas = [], []
        sums = {"val_loss": 0.0, "val_sed_loss": 0.0, "val_doa_loss": 0.0}
        n_loss = 0
        for x, sed_gt, doa_gt, _names, n_real in batch_iterator(ds, bs, pad_to_batch=True):
            x = torch.from_numpy(x).to(self.device)
            if tta is None:
                event_prob, doa, event_logit = self.eval_step(x)
                id_doa = doa
            else:
                event_prob, doa, event_logit, id_doa = self.eval_tta(x, tta)
            if np.any(sed_gt):
                losses = self.val_losses(event_logit, id_doa,
                                         torch.from_numpy(sed_gt).to(self.device),
                                         torch.from_numpy(doa_gt).to(self.device), n_real)
                for k, v in zip(sums, losses):
                    sums[k] += float(v) * n_real  # weighted by real rows
                n_loss += n_real
            probs.append(event_prob.cpu().numpy()[:n_real])
            doas.append(doa.cpu().numpy()[:n_real])
        probs, doas = np.concatenate(probs, axis=0), np.concatenate(doas, axis=0)

        counts = split_data.clip_chunk_counts
        label_frames = np.minimum(split_data.clip_label_frames, self.max_label_frames)
        l_starts, label_chunk_len = split_data.label_chunk_starts, split_data.label_chunk_len
        sed_t, doa_t = split_data.sed_targets, split_data.doa_targets
        written = []
        i = l_ptr = 0
        for ci, name in enumerate(split_data.unique_clip_names):
            k, n_label = int(counts[ci]), int(label_frames[ci])
            # the clip's label rows in the split's tables, padding included
            padded_label = int(l_starts[i + k - 1] - l_starts[i]) + label_chunk_len
            if k == 1:
                ep, dp = probs[i][:n_label], doas[i][:n_label]
            else:
                ep = combine_chunks(probs[i:i + k], label_chunk_len,
                                    split_data.label_chunk_hop, n_label, combine_method)
                dp = combine_chunks(doas[i:i + k], label_chunk_len,
                                    split_data.label_chunk_hop, n_label, combine_method)
            fn = name + ".csv"
            write = (write_trackwise_csv if self.output_format == "tracks"
                     else write_classwise_csv)
            write(os.path.join(submission_dir, fn), ep, dp, self.n_classes,
                  sed_threshold=self.sed_threshold, max_frames=n_label,
                  version=self.eval_version)
            written.append(fn)
            if output_pred_dir:
                stale = os.path.join(output_pred_dir, name + ".h5")
                if os.path.isfile(stale):  # an earlier salsa_tpu dump of this clip
                    os.remove(stale)
                np.savez(os.path.join(output_pred_dir, name + ".npz"),
                         event_frame_pred=ep[None].astype(np.float32),
                         doa_frame_pred=dp[None].astype(np.float32),
                         event_frame_gt=sed_t[l_ptr:l_ptr + n_label][None].astype(np.float32),
                         doa_frame_gt=doa_t[l_ptr:l_ptr + n_label][None].astype(np.float32))
            i += k
            l_ptr += padded_label
        self.last_val_losses = {k: v / n_loss for k, v in sums.items()} if n_loss else {}
        return written


def summary_writer(cfg):
    """A tensorboardX `SummaryWriter` on `cfg.dir.tb_dir`, as `salsa_tpu`'s trainer
    opens one; None without a tb_dir, or where tensorboardX does not import (then
    nothing is written, which the log says once)."""
    tb_dir = cfg.get("dir", {}).get("tb_dir")
    if not tb_dir:
        return None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        logger.info("tensorboardX does not import: no TensorBoard scalars are written to %s",
                    tb_dir)
        return None
    return SummaryWriter(tb_dir)


class SeldTrainer(SeldPredictor):
    @span("setup.trainer")
    def __init__(self, model, cfg, train_data, val_data, gt_meta_dir: str | None,
                 submission_dir: str, seed: int = 2021, scaler=None,
                 device: torch.device | str = "cuda", joint_transform=None,
                 feature_transform=None):
        t = cfg.training
        self.checkpoint_backend = t.get("checkpoint_backend", "msgpack")
        ckpt.check_backend(self.checkpoint_backend)
        # from_wav engages only where the train split is wav-resident, and
        # supersedes device_data (it is the resident mode, fed by waveforms)
        self.from_wav = bool(t.get("from_wav", False)) and isinstance(train_data, WavSplitData)
        self.device_data = bool(t.get("device_data", False)) and not t.get("from_wav", False)
        self.n_ranks, self.rank = distributed.process_count(), distributed.process_index()
        self.batch_size = t.train_batch_size
        mesh.data_width(self.batch_size, self.n_ranks)  # before any collective
        self.rows = distributed.local_batch_slice(self.batch_size)  # the rank's batch rows
        # sharded over the ranks from two on; with one rank it is device_data (or
        # plain from_wav), as in salsa_tpu
        self.device_data_shard = (bool(t.get("device_data_shard", False)) and self.n_ranks > 1
                                  and (self.from_wav or self.device_data))
        super().__init__(init_train_(model, torch.Generator().manual_seed(seed)), cfg, device)
        mesh.replicate(self.model)  # rank 0's initial weights on every rank
        self.seed = seed
        self.gt_meta_dir = gt_meta_dir
        self.submission_dir = submission_dir
        self.train_data = train_data
        self.val_data = val_data

        if len(train_data) < self.batch_size and (self.from_wav or self.device_data
                                                  or self.n_ranks > 1):
            raise ValueError(f"the train split has {len(train_data)} chunks, fewer than a batch "
                             f"of {self.batch_size}: no step could run")
        self.max_epochs = t.max_epochs
        train_fraction = cfg.data.get("train_fraction", 1.0)
        self.steps_per_epoch = max(1, int(len(train_data) // self.batch_size * train_fraction))
        total_steps = self.steps_per_epoch * self.max_epochs
        self.accdoa_silent_weight = float(t.get("accdoa_silent_weight", 0.0))
        self.chunk_len = train_data.feature_chunk_len
        self.label_chunk_len = train_data.label_chunk_len
        self._shard_chunk_ids = None  # per rank, the chunks of its clips (device_data_shard)
        self._feats_shard = None

        # both seeded before every step (seed_step)
        self.dropout_generator = torch.Generator(device=self.device)
        self.augment_generator = torch.Generator()
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self.dropout_generator
        self.remat_blocks = enable_remat(self.model) if t.get("remat", False) else 0
        sched = t.lr_scheduler
        self.optimizer = make_optimizer(
            self.model.parameters(), total_steps, t.get("optimizer", "adam"),
            tuple(sched.milestones), tuple(sched.lrs), tuple(sched.moms))
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info("model parameters: %.2fM | steps/epoch: %d | interp ratio: %.1f | "
                    "rank %d of %d", n_params / 1e6, self.steps_per_epoch, self.interp_ratio,
                    self.rank, self.n_ranks)
        if t.get("device_data_shard", False) and not self.device_data_shard:
            logger.info("training.device_data_shard with one rank (or off the resident "
                        "paths): the split is not sharded")
        self.setup_seconds: dict[str, float] = {}
        self.step_losses: list[float] = []  # per-step training loss of the last epoch
        self.tb = summary_writer(cfg) if distributed.is_primary() else None

        self.augment = None
        aug = t.get("device_augment", False)
        if aug:
            if self.output_format == "tracks" and aug is True:
                raise ValueError("training.device_augment: true swaps channels with the "
                                 "class-wise DOA labels; with output_format 'tracks' use "
                                 "device_augment: feature")
            # true: the full stack; "feature": no label-coupled channel swaps
            self.augment = make_device_augment(
                cfg.feature_type, cfg.data.audio_format, self.n_classes, self.chunk_len,
                train_data.features.shape[2], mode=aug if isinstance(aug, str) else "full")
        host_transforms = joint_transform is not None or feature_transform is not None
        if self.augment is not None and host_transforms:
            logger.warning("device_augment enabled: host transforms are ignored")
            joint_transform = feature_transform = None
        if self.from_wav:
            self._setup_from_wav(train_data, scaler)
        elif self.device_data:
            if host_transforms and self.augment is None:
                logger.warning("device_data: host transforms are bypassed — enable "
                               "training.device_augment for augmentation")
            if self.device_data_shard:
                self._setup_sharded_resident(train_data, t.get("device_data_dtype", "float32"))
            else:
                self._setup_resident(train_data, t.get("device_data_dtype", "float32"))
        else:
            self.train_dataset = SeldChunkDataset(train_data, joint_transform,
                                                  feature_transform)
        if self.device.type == "cuda":  # the set-up's span ends with its device work
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    @staticmethod
    def _resident_dtype(train_data, dtype: str) -> torch.dtype:
        if train_data.features.shape[1] == 0:
            raise ValueError("training.device_data needs a preloaded split (data.preload: "
                             "true)")
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"training.device_data_dtype '{dtype}': float32 or bfloat16")
        return torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def _setup_resident(self, train_data, dtype: str) -> None:
        """training.device_data: the split's features (C, T, F) and targets on the
        device once, and the chunks' feature and label start frames."""
        store_dtype = self._resident_dtype(train_data, dtype)
        dev = self.device
        t0 = time.perf_counter()
        self._feats = torch.as_tensor(train_data.features, device=dev).to(store_dtype)
        self._sed = torch.from_numpy(train_data.sed_targets).to(dev)
        self._doa = torch.from_numpy(train_data.doa_targets).to(dev)
        self._f_start = torch.as_tensor(train_data.feature_chunk_starts, device=dev)
        self._l_start = torch.as_tensor(train_data.label_chunk_starts, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.resident_bytes = sum(x.numel() * x.element_size()
                                  for x in (self._feats, self._sed, self._doa))
        self.setup_seconds["resident_upload"] = time.perf_counter() - t0
        logger.info("device_data: %d train clips resident (%s, %.2f GB)",
                    len(train_data.unique_clip_names), dtype, self.resident_bytes / 1e9)

    def _setup_sharded_resident(self, train_data, dtype: str) -> None:
        """training.device_data_shard on the store path: the split re-laid per clip,
        (n_clips padded to a multiple of the ranks, C, longest clip's frames, F), of
        which the rank's device holds its block of m clips (`mesh.shard_global`);
        each chunk's shard-local clip and clip-local start frame; the targets whole
        on every rank."""
        store_dtype = self._resident_dtype(train_data, dtype)
        dev = self.device
        t0 = time.perf_counter()
        counts = np.asarray(train_data.clip_chunk_counts)
        n_clips = len(counts)
        m = self._clips_a_rank(n_clips)
        f_starts = np.asarray(train_data.feature_chunk_starts)
        clip_of_chunk = np.repeat(np.arange(n_clips), counts)
        offsets = f_starts[np.concatenate([[0], np.cumsum(counts)[:-1]])]  # clip starts
        lens = np.diff(np.concatenate([offsets, [train_data.features.shape[1]]]))
        C, _, F = train_data.features.shape
        block = np.zeros((m, C, int(lens.max()), F), np.float32)
        for j, ci in enumerate(range(self.rank * m, min((self.rank + 1) * m, n_clips))):
            block[j, :, :lens[ci]] = train_data.features[:, offsets[ci]:offsets[ci] + lens[ci]]
        self._feats_shard = torch.from_numpy(block).to(dev).to(store_dtype)
        self._sed = torch.from_numpy(train_data.sed_targets).to(dev)
        self._doa = torch.from_numpy(train_data.doa_targets).to(dev)
        as_long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
        self._clip_local = as_long(clip_of_chunk % m)
        self._f0 = as_long(f_starts - offsets[clip_of_chunk])
        self._l_start = as_long(train_data.label_chunk_starts)
        self._set_shards(clip_of_chunk // m)
        self.resident_bytes = sum(x.numel() * x.element_size()
                                  for x in (self._feats_shard, self._sed, self._doa))
        self.setup_seconds["resident_upload"] = time.perf_counter() - t0
        logger.info("device_data_shard: %d clips over %d ranks (%d a rank, %s, %.2f GB on "
                    "this rank)", n_clips, self.n_ranks, m, dtype, self.resident_bytes / 1e9)

    def _clips_a_rank(self, n_clips: int) -> int:
        """The clips a rank holds with device_data_shard (the clips padded to a
        multiple of the ranks); fewer clips than ranks raise ValueError."""
        if n_clips < self.n_ranks:
            raise ValueError(f"device_data_shard needs at least {self.n_ranks} clips (one a "
                             f"rank); the split has {n_clips}")
        return mesh.shard_rows(n_clips, self.n_ranks)[0]

    def _set_shards(self, shard_of_chunk: np.ndarray) -> None:
        """The chunks of each rank's clips, for the stratified epoch order, and the
        epoch capped at the steps every shard can fill (`salsa_tpu`'s balanced-steps
        rule)."""
        self._shard_chunk_ids = [np.flatnonzero(shard_of_chunk == r) for r in range(self.n_ranks)]
        per = self.batch_size // self.n_ranks
        balanced = min(len(ids) // per for ids in self._shard_chunk_ids)
        if balanced < self.steps_per_epoch:
            logger.warning("device_data_shard: unbalanced clip shards cap the epoch at %d "
                           "steps (was %d)", balanced, self.steps_per_epoch)
            self.steps_per_epoch = max(1, balanced)

    def _setup_from_wav(self, train_data: WavSplitData, scaler) -> None:
        """Resident waveforms, chunk tables and tracker checkpoints on the device."""
        if scaler is None:
            raise ValueError("training.from_wav needs a fitted scaler "
                             "(data.wav_database.fit_scaler_from_waves)")
        cfg, d, dev = self.cfg, self.cfg.data, self.device
        self.chunk_fn, p = make_chunk_extractor(
            cfg.feature_type, d.audio_format, self.chunk_len, fs=d.fs, n_fft=d.n_fft,
            hop_length=d.hop_len, win_length=d.get("win_len", None),
            fmin_doa=d.get("fmin_doa", 50), fmax_doa=d.get("fmax_doa", None),
            n_mels=d.get("n_mels", 128), fmin=d.get("fmin", 50), fmax=d.get("fmax", None),
            eig_method=cfg.training.get("eig_method", "auto"))
        self.feature_params = p
        self.n_spec_channels = feature_n_spec_channels(cfg.feature_type)
        self.wav_scale = train_data.wav_scale
        clip_of_chunk = train_data.clip_of_chunk
        clip_table = clip_of_chunk
        self._clip_base = 0  # the first clip on this rank's device
        if self.device_data_shard:
            # the rank's block of clips on its device; the chunk table's clips
            # shard-local, and the stratified epoch order keeps every rank on its own
            n_clips = train_data.waves.shape[0]
            m = self._clips_a_rank(n_clips)
            self._waves = torch.from_numpy(mesh.shard_global(train_data.waves, self.rank,
                                                             self.n_ranks)).to(dev)
            self._clip_base = self.rank * m
            clip_table = clip_of_chunk % m
            self._set_shards(clip_of_chunk // m)
            logger.info("from_wav device_data_shard: %d clips over %d ranks (%d a rank, %.2f "
                        "GB on this rank)", n_clips, self.n_ranks, m,
                        self._waves.numel() * self._waves.element_size() / 1e9)
        else:
            self._waves = torch.from_numpy(train_data.waves).to(dev)

        self._floor_ck = self._cd_ck = None
        if isinstance(p, SalsaParams) and p.is_tracking:
            self._tracker_checkpoints(train_data, p)

        as_long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
        n_valid = np.minimum(train_data.clip_trimmed_frames[clip_of_chunk]
                             - train_data.within_clip_start, self.chunk_len)
        self._clip = as_long(clip_table)
        self._f0 = as_long(train_data.within_clip_start)
        self._n_full = as_long(train_data.clip_full_frames[clip_of_chunk])
        self._n_valid = as_long(n_valid)
        self._l_start = as_long(train_data.label_chunk_starts)
        self._sed = torch.from_numpy(train_data.sed_targets).to(dev)
        self._doa = torch.from_numpy(train_data.doa_targets).to(dev)
        self.mean = torch.as_tensor(np.asarray(scaler[0], np.float32), device=dev)
        self.std = torch.as_tensor(np.asarray(scaler[1], np.float32), device=dev)

    def _tracker_checkpoints(self, train_data: WavSplitData, p: SalsaParams) -> None:
        """The tracker state entering every chunk's first frame, from the dequantized
        RESIDENT samples (what the step's tracker reads), clips of equal length
        batched into K2 launches with collect_states; with device_data_shard, for
        the chunks of the rank's clips only."""
        dev, clip_of_chunk = self.device, train_data.clip_of_chunk
        t0 = time.perf_counter()
        n_band = p.upper_bin - p.lower_bin
        self._floor_ck = torch.zeros((len(train_data), n_band), dtype=torch.float32, device=dev)
        self._cd_ck = torch.zeros((len(train_data), n_band), dtype=torch.int32, device=dev)
        base = self._clip_base
        own = list(range(base, min(base + self._waves.shape[0], len(train_data.clip_wavs))))
        for group_idx in length_groups([train_data.clip_wavs[ci] for ci in own],
                                       lambda w: w.shape[1]):
            cis = [own[j] for j in group_idx]
            s_pad = train_data.clip_wavs[cis[0]].shape[1] + 2 * train_data.wav_pad
            group = self._waves[[ci - base for ci in cis], :, :s_pad].float() * self.wav_scale
            starts = [train_data.within_clip_start[clip_of_chunk == ci] for ci in cis]
            for ci, (fl, cd) in zip(cis, salsa_tracker_checkpoints_batch(group, starts, p)):
                sel = torch.from_numpy(np.flatnonzero(clip_of_chunk == ci)).to(dev)
                self._floor_ck[sel], self._cd_ck[sel] = fl, cd
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.setup_seconds["tracker_checkpoints"] = time.perf_counter() - t0
        logger.info("from_wav: tracker checkpoints for %d clips in %.1fs",
                    len(own), self.setup_seconds["tracker_checkpoints"])

    # ------------------------------------------------------------------
    def normalize(self, x: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
        """Chunks (B, C, chunk_len, F) -> the scaler's channels (the feature type's
        n_spec_channels) normalized by the train-split scaler, and frames past each
        chunk's n_valid (B,) zeroed."""
        mean, std = self.mean.to(x.device), self.std.to(x.device)
        n = self.n_spec_channels
        x = torch.cat([(x[:, :n] - mean) / std, x[:, n:]], dim=1)
        # the short-clip pad region is true zeros in the feature-store path, which
        # pads after normalization
        ok = torch.arange(self.chunk_len, device=x.device) < n_valid[:, None]
        return x * ok[:, None, :, None].to(x.dtype)

    @span("train.batch")
    def batch(self, chunk_ids):
        """(x, sed, doa) on the device of the chunks `chunk_ids` (B,), the rank's rows
        of a batch: normalized feature chunks (B, C, chunk_len, F) and their label
        windows, extracted from the resident waveforms, gathered from the resident
        split (or the rank's block of it), or read on the host (with the host
        transforms, which draw from their generator)."""
        if not (self.from_wav or self.device_data):
            samples = [self.train_dataset[int(j)] for j in chunk_ids]
            return self.to_device(tuple(torch.from_numpy(np.stack([s[k] for s in samples]))
                                        for k in range(3)))
        i = torch.as_tensor(np.asarray(chunk_ids, np.int64), device=self.device)
        rows = self._l_start[i][:, None] + torch.arange(self.label_chunk_len, device=self.device)
        if self._feats_shard is not None:  # device_data_shard: windows of the rank's clips
            frames = self._f0[i][:, None] + torch.arange(self.chunk_len, device=self.device)
            x = self._feats_shard[self._clip_local[i][:, None], :, frames]  # (B, L, C, F)
            return x.permute(0, 2, 1, 3).contiguous().float(), self._sed[rows], self._doa[rows]
        if self.device_data:
            frames = self._f_start[i][:, None] + torch.arange(self.chunk_len, device=self.device)
            x = self._feats[:, frames].transpose(0, 1).contiguous().float()
            return x, self._sed[rows], self._doa[rows]
        state = (None, None) if self._floor_ck is None else (self._floor_ck[i], self._cd_ck[i])
        x = self.chunk_fn(self._waves, self._clip[i], self._f0[i], self._n_full[i], *state,
                          self.wav_scale)
        x = self.normalize(x, self._n_valid[i])
        return x, self._sed[rows], self._doa[rows]

    def host_batches(self, epoch: int):
        """The host path's epoch: at most steps_per_epoch batches (x, sed, doa) of
        CPU tensors, pinned where the device is a card, in `batch_iterator`'s
        shuffled order of (seed, epoch), the incomplete tail dropped where the split
        holds a batch (`salsa_tpu`'s rule), windows read on `training.data_workers`
        threads. No batch past the epoch's last step is built, so the host
        transforms' draws do not depend on how far a prefetch thread ran ahead.
        With more than one rank, each batch is the rank's rows of the global batch
        (`batch_iterator(process_shard=)`)."""
        multi = self.n_ranks > 1
        it = batch_iterator(
            self.train_dataset, self.batch_size, shuffle=True, rng=self._shuffle_rng(epoch),
            drop_last=multi or len(self.train_dataset) >= self.batch_size,
            process_shard=(self.rank, self.n_ranks) if multi else None,
            num_workers=int(self.cfg.training.get("data_workers", 0)))
        pin = self.device.type == "cuda"
        try:
            for _step, (x, sed, doa, _names, _n) in zip(range(self.steps_per_epoch), it):
                batch = tuple(torch.from_numpy(a) for a in (x, sed, doa))
                yield tuple(b.pin_memory() for b in batch) if pin else batch
        finally:
            it.close()

    def to_device(self, batch):
        """A host batch on the device: a non-blocking copy from pinned memory."""
        return tuple(b.to(self.device, non_blocking=True) for b in batch)

    def loss(self, out: dict[str, torch.Tensor], sed: torch.Tensor, doa: torch.Tensor):
        """(total, sed_loss, doa_loss) of the model's framewise outputs `out` on a
        batch's label windows."""
        pred = {k: interpolate_index_repeat(out[k], self.interp_ratio)
                for k in ("event_frame_logit", "doa_frame_output")}
        target = {"event_frame_gt": sed, "doa_frame_gt": doa}
        # across ranks: the global batch's denominators, so the ranks' losses add up
        gsum = distributed.all_reduce_sum if self.n_ranks > 1 else None
        if self.output_format == "reg_xyz":
            return seld_loss(pred, target, self.n_classes, self.loss_weight, global_sum=gsum)
        if self.output_format == "tracks":
            return tpit_loss(pred["event_frame_logit"], pred["doa_frame_output"],
                             *self.track_targets(sed, doa), self.loss_weight, global_sum=gsum)
        return accdoa_loss(pred, target, self.n_classes, silent_weight=self.accdoa_silent_weight,
                           global_sum=gsum)

    @span("train.forward_backward")
    def forward_backward(self, x, sed, doa) -> dict[str, torch.Tensor]:
        """Training-mode forward, loss and backward; the gradients are left on the
        parameters for the optimizer's step. Across ranks the gradients and the
        losses are then summed over the ranks (`all_reduce_grads`): the global
        batch's."""
        self.model.train()
        total, sed_l, doa_l = self.loss(self.model(x), sed, doa)
        self.optimizer.zero_grad()
        with span("train.backward"):
            total.backward()
        if self.n_ranks > 1:
            total, sed_l, doa_l = self.all_reduce_grads(torch.stack([total, sed_l, doa_l]))
        return {"loss": total.detach(), "sed_loss": sed_l.detach(), "doa_loss": doa_l.detach()}

    def all_reduce_grads(self, losses: torch.Tensor) -> torch.Tensor:
        """Every parameter's gradient and the rank's `losses` summed over the ranks
        in one flattened all-reduce; returns the summed losses. Each rank's loss is
        its numerator over the global denominator, so the sums are the global
        batch's loss and gradient."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads] + [losses.detach().to(grads[0].dtype)])
        distributed.all_reduce_sum(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[offset:]

    def seed_step(self) -> None:
        """Seed the dropout and augmentation generators for the next step from
        (seed, optimizer count)."""
        count = self.optimizer.count
        self.dropout_generator.manual_seed(step_seed(self.seed, count, DROPOUT_STREAM))
        self.augment_generator.manual_seed(step_seed(self.seed, count, AUGMENT_STREAM))

    def augment_batch(self, x, sed, doa):
        """(x, sed, doa) augmented with the step's draws, or as they are without
        `training.device_augment`. Across ranks the draws are the global batch's,
        of which the rank applies its rows'."""
        if self.augment is None:
            return x, sed, doa
        if self.n_ranks == 1:
            return self.augment(self.augment_generator, x, sed, doa)
        draws = self.augment.draw(self.batch_size, self.augment_generator).rows(self.rows)
        return self.augment.apply(draws.to(x.device), x, sed, doa)

    def step_on(self, x, sed, doa) -> dict[str, torch.Tensor]:
        """One optimizer step on a batch on the device; returns its losses."""
        self.seed_step()
        metrics = self.forward_backward(*self.augment_batch(x, sed, doa))
        with span("train.optimizer"):
            self.optimizer.step()
        return metrics

    @span("train.step")
    def train_step(self, chunk_ids) -> dict[str, torch.Tensor]:
        """One optimizer step on the global batch `chunk_ids`, of which this rank
        takes its rows; returns the batch's losses."""
        return self.step_on(*self.batch(np.asarray(chunk_ids)[self.rows]))

    # ------------------------------------------------------------------
    def _shuffle_rng(self, epoch: int) -> np.random.Generator:
        """The epoch's shuffle generator, a pure function of (seed, epoch)."""
        return np.random.default_rng((self.seed, epoch))

    def _epoch_order(self, epoch: int) -> np.ndarray:
        """The chunk visit order of an epoch, a pure function of (seed, epoch): a
        shuffle of the split, or with device_data_shard `salsa_tpu`'s
        shard-stratified order, in which column block r of every batch holds
        batch / N chunks of rank r's clips (each shard's chunks shuffled in rank
        order)."""
        rng = self._shuffle_rng(epoch)
        if self._shard_chunk_ids is not None:
            return stratified_order(self._shard_chunk_ids, self.batch_size, rng)
        order = np.arange(len(self.train_data))
        rng.shuffle(order)
        return order

    def train_epoch(self, epoch: int) -> dict:
        """One epoch's steps; returns the global batch's mean losses, lr and
        momentum."""
        if not (self.from_wav or self.device_data):
            pending = [self.step_on(*self.to_device(b))
                       for b in prefetch(self.host_batches(epoch))]
            return self._finish_epoch(pending)
        order = self._epoch_order(epoch)
        usable = min(self.steps_per_epoch * self.batch_size, len(order))
        pending = [self.train_step(order[s * self.batch_size:(s + 1) * self.batch_size])
                   for s in range(usable // self.batch_size)]
        return self._finish_epoch(pending)

    def _finish_epoch(self, pending: list[dict[str, torch.Tensor]]) -> dict:
        """Mean losses of the epoch's steps (one device sync), lr and momentum."""
        stacked = {k: torch.stack([m[k] for m in pending]).cpu().numpy() for k in pending[0]}
        self.step_losses = [float(v) for v in stacked["loss"]]
        avgs = {k: float(sum(float(x) for x in v)) / len(pending) for k, v in stacked.items()}
        avgs["lr"] = float(self.optimizer.lr)
        avgs["momentum"] = float(self.optimizer.b1)
        self.add_scalars("train", avgs)
        return avgs

    def add_scalars(self, group: str, values: dict) -> None:
        """`<group>/<key>` for each value at the optimizer's step count, where a
        TensorBoard writer is open (rank 0, tensorboardX importable)."""
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(f"{group}/{k}", v, self.optimizer.count)

    # ------------------------------------------------------------------
    def _host_rngs(self) -> list[np.random.Generator]:
        """The generators the host transforms draw from (one, from
        `build_train_transforms`), in order of first use; none off the host path."""
        ds = getattr(self, "train_dataset", None)
        found: dict[int, np.random.Generator] = {}
        stack = [] if ds is None else [ds.joint_transform, ds.transform]
        while stack:
            t = stack.pop(0)
            if t is None:
                continue
            if isinstance(getattr(t, "rng", None), np.random.Generator):
                found.setdefault(id(t.rng), t.rng)
            stack.extend(getattr(t, "transforms", []) + getattr(t, "choices", []))
        return list(found.values())

    def host_rng_meta(self) -> dict:
        """The host transforms' generator states for the sidecar
        (`host_transform_rng`, rank 0's), so that a resumed run draws what the
        uninterrupted run draws; with more than one rank also every rank's
        (`host_transform_rng_by_rank`), gathered to rank 0: a collective, {} on the
        other ranks."""
        states = [g.bit_generator.state for g in self._host_rngs()]
        by_rank = distributed.gather_objects(states)
        if not states or by_rank is None:
            return {}
        if self.n_ranks == 1:
            return {"host_transform_rng": states}
        return {"host_transform_rng": by_rank[0], "host_transform_rng_by_rank": by_rank}

    def save(self, ckpt_dir: str, name: str, meta: dict) -> str | None:
        """Write the model and optimizer as a checkpoint of `training.checkpoint_backend`
        (flax msgpack or `.orbax`) with its sidecar (`host_rng_meta` added); returns
        its path. Every rank calls it and rank 0 writes (None elsewhere)."""
        meta = {**meta, **self.host_rng_meta()}
        return self._write(ckpt_dir, name, meta) if distributed.is_primary() else None

    def _write(self, ckpt_dir: str, name: str, meta: dict) -> str:
        params, stats = torch_state_dict_to_flax(self.model.state_dict(),
                                                 torch_tree=not self.model.flax_counterpart)
        return ckpt.save_checkpoint(ckpt_dir, name, params, stats, self.optimizer.count, meta,
                                    opt_state=self.optimizer.optax_state(self.model),
                                    backend=self.checkpoint_backend)

    def restore(self, path: str) -> int:
        """Restore the weights, BatchNorm statistics and optimizer state of the
        checkpoint `path` (the port's or `salsa_tpu`'s), and the host transforms'
        generator states where the sidecar has them (this rank's, where it keeps
        every rank's of a run on as many ranks); returns the epoch to continue
        from: the sidecar's epoch + 1, or else count // steps_per_epoch. Every rank
        restores the same file."""
        params, stats, opt_state = ckpt.restore_train_state(path)
        load_flax_variables(self.model, params, stats)
        self.optimizer.load_optax_state(self.model, opt_state)
        meta = ckpt.load_metadata(path)
        by_rank = meta.get("host_transform_rng_by_rank", [])
        states = (by_rank[self.rank] if len(by_rank) == self.n_ranks
                  else meta.get("host_transform_rng", []))
        for g, state in zip(self._host_rngs(), states):
            g.bit_generator.state = state
        if "epoch" in meta:
            start_epoch = int(meta["epoch"]) + 1
        else:
            start_epoch = self.optimizer.count // self.steps_per_epoch
        logger.info("Resumed from %s at step %d (epoch %d)", path, self.optimizer.count,
                    start_epoch)
        return start_epoch

    def fit(self, resume_from: str | None = None):
        """Train from epoch 0, or from the checkpoint `resume_from` (every rank
        restores it); rank 0 validates and writes the checkpoints."""
        # every rank here before the first collective: a slow setup on one rank
        # (data, tracker checkpoints) does not count against a collective's wait
        distributed.barrier("fit_start")
        start_epoch = self.restore(resume_from) if resume_from else 0
        best_seld = float("inf")
        ckpt_dir, best_dir = self.cfg.dir.model.checkpoint, self.cfg.dir.model.best
        val_interval = self.cfg.training.get("val_interval", 1)
        t0 = time.time()
        for epoch in range(start_epoch, self.max_epochs):
            metrics = self.train_epoch(epoch)
            if not np.isfinite(metrics.get("loss", 0.0)):
                logger.error("Epoch %d: non-finite loss %s — stopping. Resume from "
                             "the last checkpoint with a lower LR.", epoch, metrics)
                raise FloatingPointError(f"training diverged at epoch {epoch}")
            logger.info("Epoch %d/%d - loss %.4f (sed %.4f, doa %.4f) - %.1fs elapsed",
                        epoch, self.max_epochs - 1, metrics["loss"], metrics["sed_loss"],
                        metrics["doa_loss"], time.time() - t0)
            meta: dict[str, Any] = {"epoch": epoch, **metrics, **self.host_rng_meta()}
            if not distributed.is_primary():
                continue  # validation and checkpoints are rank 0's
            if self.val_data is not None and (epoch + 1) % val_interval == 0:
                scores = self.validate()
                meta.update({f"val{k}": v for k, v in scores.items() if k != "seld_error"})
                logger.info("Epoch %d - val SELD %.4f - ER %.4f F1 %.4f LE %.2f LR %.4f",
                            epoch, scores["seld_error"], scores["ER"], scores["F1"],
                            scores["LE"], scores["LR"])
                self.add_scalars("val", scores)
                meta["valSeld"] = scores["seld_error"]
                if scores["seld_error"] < best_seld:
                    best_seld = scores["seld_error"]
                    self._write(best_dir, "best", meta)
                    logger.info("New best valSeld %.4f saved", best_seld)
            self._write(ckpt_dir, f"epoch{epoch:03d}", meta)
        if self.tb is not None:
            self.tb.flush()
        distributed.barrier("fit_end")  # no rank leaves before rank 0's last checkpoint
        return self.model

    def validate(self) -> dict:
        tmp_dir = os.path.join(self.submission_dir, "_temp")
        shutil.rmtree(tmp_dir, ignore_errors=True)
        val_data = self.val_data
        val_fraction = float(self.cfg.data.get("val_fraction", 1.0))
        if val_fraction < 1.0:
            val_data = truncate_clips(
                val_data, int(np.ceil(len(val_data.unique_clip_names) * val_fraction)))
        written = self.predict_split(val_data, tmp_dir)
        if self.last_val_losses:
            logger.info("val losses: total %.4f (sed %.4f, doa %.4f)",
                        self.last_val_losses["val_loss"], self.last_val_losses["val_sed_loss"],
                        self.last_val_losses["val_doa_loss"])
            self.add_scalars("val", self.last_val_losses)
        return evaluate_submissions(tmp_dir, self.gt_meta_dir, version=self.eval_version,
                                    n_classes=self.n_classes, doa_threshold=self.doa_threshold,
                                    label_rate=self.label_rate, filenames=written)
