"""Rank worker of the port's data-parallel tests (tests/test_torch_parallel*.py).

Importable (the problems, so that a test builds the same data for `salsa_tpu`'s
trainer) and executable: `python tests/torch_parallel_worker.py <spec.json>`,
spawned once per rank with torchrun's or `salsa_tpu`'s environment, forms the
gloo group (`salsa_tpu_torch.parallel.distributed.initialize`), trains the
spec's problem with the port's SeldTrainer on the CPU and prints one JSON line
with its per-step and per-epoch losses.

Spec keys: `mode` ("host", "device_data", "shard", "from_wav", "bn", "loss",
"cli"), `seed`, `epochs`, `init` (an .npz of torch-named weights loaded after the
trainer is built, e.g. a flax init), `workdir`, `position_dropout` (every
dropout's mask a fixed function of the element's logical coordinates, the same
function `salsa_tpu`'s patched dropout uses), `replay_augment` (the augmentation
draws of `salsa_tpu`'s key tree for the step, replayed), `resume` and
`max_epochs`.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 300  # a rank that has not finished by then fails its test
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE", "SALSA_COORDINATOR", "SALSA_NUM_PROCESSES", "SALSA_PROCESS_ID")

N_CLASSES = 3
DROP_P = 0.2
ENC = {"name": "PannResNet22", "n_input_channels": 7}
DEC = {"name": "SeldDecoder", "decoder_type": "gru", "decoder_size": 16, "freq_pool": "avg",
       "head_dropout": 0.0, "rnn_dropout": 0.0}
DEC_DROPOUT = dict(DEC, head_dropout=DROP_P, rnn_dropout=DROP_P)
LR = {"milestones": [0.0, 1.0], "lrs": [1e-4, 1e-4], "moms": [0.9, 0.9]}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, n_ranks: int, port: int, launcher: str = "torchrun") -> dict:
    """The environment of rank `rank` of `n_ranks` (none of the variables with one
    rank): torchrun's or `salsa_tpu`'s SALSA_* variables."""
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env["PYTHONPATH"] = REPO
    if n_ranks == 1:
        return env
    if launcher == "torchrun":
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(n_ranks), LOCAL_RANK=str(rank))
    else:
        env.update(SALSA_COORDINATOR=f"127.0.0.1:{port}", SALSA_NUM_PROCESSES=str(n_ranks),
                   SALSA_PROCESS_ID=str(rank))
    return env


def launch(spec: dict, n_ranks: int, tmp: str, launcher: str = "torchrun",
           argv: list[str] | None = None) -> list[dict]:
    """Run `n_ranks` processes of this worker on `spec` (or of `argv`, a command
    whose last stdout line is JSON) with a fresh port, each with its own
    timeout; returns each rank's JSON line, raising with a failed rank's stderr."""
    path = os.path.join(tmp, f"spec_{spec.get('mode', 'cli')}_{n_ranks}_{free_port()}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    cmd = argv or [sys.executable, os.path.join(REPO, "tests", "torch_parallel_worker.py"), path]
    port = free_port()
    procs = [subprocess.Popen(cmd, env=rank_env(r, n_ranks, port, launcher), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n_ranks)]
    outs, failed = [], []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
            else:
                outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        raise AssertionError("\n".join(failed))
    return outs


def feature_arrays(seed: int = 5, n_clips: int = 8, chunks_per_clip: int = 4, chunk: int = 64,
                   label_chunk: int = 32, n_feat: int = 32) -> dict:
    """The arrays of a feature-level split (tests/test_shard_resident.py's
    build_split, with seeded targets whose halves of a batch differ in mask
    mass): 8 clips of 4 chunks, 7 x 64 x 32 windows, 3 classes."""
    rng = np.random.default_rng(seed)
    clip_t = chunk * chunks_per_clip
    features = rng.standard_normal((7, clip_t * n_clips, n_feat)).astype(np.float32)
    n_label = label_chunk * chunks_per_clip * n_clips
    sed = (rng.random((n_label, N_CLASSES)) < rng.uniform(0.1, 0.6, (n_label, 1))).astype(
        np.float32)
    doa = (rng.standard_normal((n_label, 3 * N_CLASSES)) * 0.5).astype(np.float32)
    f_starts = [c * clip_t + k * chunk for c in range(n_clips) for k in range(chunks_per_clip)]
    l_starts = [(c * chunks_per_clip + k) * label_chunk for c in range(n_clips)
                for k in range(chunks_per_clip)]
    return dict(features=features, sed_targets=sed, doa_targets=doa,
                feature_chunk_starts=np.asarray(f_starts), label_chunk_starts=np.asarray(l_starts),
                clip_names=[f"c{c}" for c in range(n_clips) for _ in range(chunks_per_clip)],
                feature_chunk_len=chunk, feature_chunk_hop=chunk, label_chunk_len=label_chunk,
                label_chunk_hop=label_chunk, chunks_per_clip=chunks_per_clip,
                unique_clip_names=[f"c{c}" for c in range(n_clips)],
                clip_chunk_counts=np.full(n_clips, chunks_per_clip),
                clip_label_frames=np.full(n_clips, label_chunk * chunks_per_clip))


def feature_config(mode: str, batch: int = 4, epochs: int = 2, augment: bool = False,
                   train_fraction: float = 0.25) -> dict:
    """The trainer config of a feature-level problem (at batch 4, 2 steps an epoch;
    1 at train_fraction 0.125)."""
    training = {"train_batch_size": batch, "max_epochs": epochs, "steps_per_dispatch": 1,
                "lr_scheduler": LR, "device_data": mode in ("device_data", "shard"),
                "device_data_shard": mode == "shard"}
    if augment:
        training["device_augment"] = True
    return {"feature_type": "salsa",
            "data": {"fs": 8000, "hop_len": 400, "n_classes": N_CLASSES, "label_rate": 10,
                     "output_format": "reg_xyz", "audio_format": "foa",
                     "train_fraction": train_fraction},
            "training": training}


def logical_keep(shape, layout: str):
    """A dropout keep mask of `shape` that is a fixed function of each element's
    logical coordinates (batch, time, frequency, channel), so that an NHWC
    (`salsa_tpu`) and an NCHW (the port) tensor drop the same elements; 3-D
    tensors are (batch, time, feature) in both."""
    idx = np.indices(shape)
    if len(shape) == 4:
        b, t, f, c = (idx[0], idx[1], idx[2], idx[3]) if layout == "nhwc" else (
            idx[0], idx[2], idx[3], idx[1])
        code = b * 7 + t * 3 + f * 5 + c * 11
    else:
        code = idx[0] * 7 + idx[1] * 3 + idx[-1] * 11
    return (code % 10) >= int(DROP_P * 10)


def _patch_position_dropout():
    import torch

    from salsa_tpu_torch.models.layers import Dropout

    def keep_mask(self, shape, device):
        return torch.from_numpy(logical_keep(tuple(shape), "nchw")).to(device)

    Dropout.keep_mask = keep_mask


def _patch_replayed_augment(seed: int):
    """The port's DeviceAugment.draw returns the draws `salsa_tpu`'s trainer takes
    at the step: its key fold_in(PRNGKey(seed), step), split, the first half
    (the test gives `salsa_tpu`'s trainer that threefry key)."""
    import jax

    from salsa_tpu_torch.train import device_augment as tda
    from salsa_tpu_torch.train import trainer as ttrainer
    from tests.test_torch_device_augment import replay_batch

    step = {"count": 0}
    seed_step = ttrainer.SeldTrainer.seed_step

    def seed_and_record(self):
        step["count"] = self.optimizer.count
        seed_step(self)

    def draw(self, batch_size, generator):
        key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), step["count"]))[0]
        return replay_batch(key, batch_size, self)[0]

    ttrainer.SeldTrainer.seed_step = seed_and_record
    tda.DeviceAugment.draw = draw


def feature_trainer(spec: dict):
    from salsa_tpu_torch.data.database import SplitData
    from salsa_tpu_torch.models.seld import build_model
    from salsa_tpu_torch.train.trainer import SeldTrainer
    from salsa_tpu_torch.utils.config import AttrDict

    cfg = feature_config(spec["mode"], spec.get("batch", 4), spec.get("max_epochs", 2),
                         spec.get("augment", False), spec.get("train_fraction", 0.25))
    dec = DEC_DROPOUT if spec.get("dropout") else DEC
    return SeldTrainer(model=build_model(encoder=ENC, decoder=dec, n_classes=N_CLASSES),
                       cfg=AttrDict(cfg), train_data=SplitData(**feature_arrays()),
                       val_data=None, gt_meta_dir=None,
                       submission_dir=os.path.join(spec["workdir"], "sub"),
                       seed=spec["seed"], device="cpu")


def wav_trainer(spec: dict):
    """The from-wav problem: tests/test_torch_trainer.py's corpus (written by the
    test into workdir), its geometry and scaler (an .npz beside it)."""
    from salsa_tpu_torch.data import wav_database as twav
    from salsa_tpu_torch.data.database import SeldDatabase
    from salsa_tpu_torch.features.registry import make_extractor
    from salsa_tpu_torch.models.seld import build_model
    from salsa_tpu_torch.train.trainer import SeldTrainer
    from salsa_tpu_torch.utils.config import AttrDict

    root = spec["corpus"]
    geometry = spec["geometry"]
    db = SeldDatabase(store=twav.MemoryFeatureStore({}, None), gt_meta_root_dir=root, **geometry)
    db.n_fft = spec["n_fft"]
    ex = make_extractor("salsa", "foa", fs=geometry["fs"], n_fft=spec["n_fft"],
                        hop_length=geometry["hop_len"], fmax_doa=3000.0)
    split = twav.load_wav_split(db, "train", os.path.join(root, "foa_dev"),
                                split_meta_dir=os.path.join(root, "meta"), n_channels=7,
                                n_features=ex.n_features)
    sc = np.load(spec["scaler"])
    return SeldTrainer(model=build_model(encoder=ENC, decoder=DEC, n_classes=N_CLASSES),
                       cfg=AttrDict(spec["config"]), train_data=split, val_data=None,
                       gt_meta_dir=None, submission_dir=os.path.join(spec["workdir"], "sub"),
                       seed=spec["seed"], scaler=(sc["mean"], sc["std"]), device="cpu")


def bn_problem(seed: int = 11, shape=(6, 5, 7, 9)):
    """A batch for the BatchNorm test (rows of unequal scale, a channel offset)
    and the upstream gradient of its output."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 3.0, (shape[0], 1, 1, 1))
         + np.arange(shape[1])[None, :, None, None]).astype(np.float32)
    return x, rng.standard_normal(shape).astype(np.float32)


def bn_rank(spec: dict) -> dict:
    """Two training-mode BatchNorm steps on the rank's rows of bn_problem: the
    output, the input's, scale's and shift's gradients of the first step and the
    running statistics after both."""
    import torch

    from salsa_tpu_torch.models.layers import batch_norm
    from salsa_tpu_torch.parallel import distributed

    x, gy = bn_problem()
    rows = distributed.local_batch_slice(x.shape[0])
    torch.manual_seed(0)
    bn = batch_norm(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    xt = torch.from_numpy(x[rows]).requires_grad_(True)
    y = bn(xt)
    y.backward(torch.from_numpy(gy[rows]))
    bn(torch.from_numpy(x[rows] * 0.5 + 1.0))
    return {"y": y.detach().numpy().tolist(), "gx": xt.grad.numpy().tolist(),
            "gw": bn.weight.grad.numpy().tolist(), "gb": bn.bias.grad.numpy().tolist(),
            "running_mean": bn.running_mean.numpy().tolist(),
            "running_var": bn.running_var.numpy().tolist(), "rows": [rows.start, rows.stop]}


def loss_problem(seed: int = 13, b: int = 4, t: int = 10):
    """Predictions and targets whose batch halves have different mask masses."""
    rng = np.random.default_rng(seed)
    sparse = np.array([0.1, 0.1, 0.7, 0.7])[:, None, None]
    sed = (rng.random((b, t, N_CLASSES)) < sparse).astype(np.float32)
    pred = {"event_frame_logit": rng.normal(0, 2, (b, t, N_CLASSES)).astype(np.float32),
            "doa_frame_output": np.tanh(rng.normal(0, 1, (b, t, 3 * N_CLASSES))).astype(
                np.float32)}
    target = {"event_frame_gt": sed,
              "doa_frame_gt": (rng.normal(0, 0.5, (b, t, 3 * N_CLASSES))
                               * np.tile(sed, 3)).astype(np.float32)}
    return pred, target


def loss_rank(spec: dict) -> dict:
    """The rank's reg_xyz and accdoa losses (global denominators) on its rows of
    loss_problem, and their gradients with respect to its predictions."""
    import torch

    from salsa_tpu_torch.parallel import distributed
    from salsa_tpu_torch.train.losses import accdoa_loss, seld_loss

    pred, target = loss_problem()
    rows = distributed.local_batch_slice(target["event_frame_gt"].shape[0])
    out = {}
    for name, fn in (("reg_xyz", lambda p, t: seld_loss(p, t, N_CLASSES, global_sum=gsum)),
                     ("accdoa", lambda p, t: accdoa_loss(p, t, N_CLASSES, silent_weight=0.5,
                                                         global_sum=gsum))):
        gsum = distributed.all_reduce_sum
        p = {k: torch.from_numpy(v[rows]).requires_grad_(True) for k, v in pred.items()}
        t = {k: torch.from_numpy(v[rows]) for k, v in target.items()}
        total, sed_l, doa_l = fn(p, t)
        total.backward()
        out[name] = {"losses": [float(v.detach()) for v in (total, sed_l, doa_l)],
                     "grads": {k: v.grad.numpy().tolist() for k, v in p.items()
                               if v.grad is not None}}
    return out


def cli_rank(spec: dict) -> dict:
    """`cli.train.train` on the CPU (the config `spec['config']`, its
    `overrides`, `resume`), then the sidecars' epoch losses and the trainer's
    rank."""
    from salsa_tpu_torch.cli import train as cli_train
    from salsa_tpu_torch.train import checkpoint as ckpt

    tr = cli_train.train(spec["config"], spec["group"], overrides=spec.get("overrides"),
                         device="cpu", resume=spec.get("resume", False))
    ck_dir = tr.cfg.dir.model.checkpoint
    return {"rank": tr.rank, "n_ranks": tr.n_ranks, "count": tr.optimizer.count,
            "steps_per_epoch": tr.steps_per_epoch,
            "epoch_losses": [ckpt.load_metadata(os.path.join(ck_dir, f"epoch{e:03d}.msgpack"))[
                "loss"] for e in range(tr.max_epochs)]}


def train(spec: dict) -> dict:
    import torch

    from salsa_tpu_torch.train import checkpoint as ckpt

    if spec.get("position_dropout"):
        _patch_position_dropout()
    if spec.get("replay_augment"):
        _patch_replayed_augment(spec["seed"])
    tr = wav_trainer(spec) if spec["mode"] == "from_wav" else feature_trainer(spec)
    if spec.get("init"):
        sd = np.load(spec["init"])
        tr.model.load_state_dict({k: torch.from_numpy(sd[k]) for k in sd.files}, strict=True)
    out = {"rank": tr.rank, "n_ranks": tr.n_ranks, "steps_per_epoch": tr.steps_per_epoch}
    if spec.get("fit"):  # fit, with the epoch checkpoints' losses read back
        ck_dir = os.path.join(spec["workdir"], "ckpt")
        tr.cfg.dir = {"model": {"checkpoint": ck_dir,
                                "best": os.path.join(spec["workdir"], "best")}}
        resume = ckpt.latest_checkpoint(ck_dir) if spec.get("resume") else None
        tr.fit(resume_from=resume)
        out["epoch_losses"] = [ckpt.load_metadata(os.path.join(ck_dir, f"epoch{e:03d}.msgpack"))[
            "loss"] for e in range(tr.max_epochs)] if tr.rank == 0 else []
        out["count"] = tr.optimizer.count
        return out
    losses, steps = [], []
    for epoch in range(spec.get("epochs", 2)):
        losses.append(tr.train_epoch(epoch)["loss"])
        steps += tr.step_losses
    out.update(epoch_losses=losses, step_losses=steps, count=tr.optimizer.count,
               weights={k: float(v.double().sum()) for k, v in tr.model.state_dict().items()})
    return out


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(1)
    from salsa_tpu_torch.parallel import distributed

    with open(sys.argv[1]) as f:
        spec = json.load(f)
    distributed.initialize(timeout_s=300.0)
    run = {"bn": bn_rank, "loss": loss_rank, "cli": cli_rank}.get(spec["mode"], train)
    try:
        out = run(spec)
    finally:
        distributed.shutdown()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
