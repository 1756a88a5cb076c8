"""The port's data parallelism on the CPU (`salsa_tpu_torch.parallel`, the
trainer over ranks): 2 gloo ranks spawned with a free port and a timeout a
process (tests/torch_parallel_worker.py). The cross-rank BatchNorm (forward,
backward, running statistics) against one process's BatchNorm on the
concatenated batch, and the global loss denominators on a batch whose halves
have different mask masses against one process's losses on the whole batch,
within 1e-6; `batch_iterator(process_shard=)` rows bit-equal to `salsa_tpu`'s;
the port's 2 ranks against its 1 rank with dropout and the device augmentation
drawn from their generators; `cli.train` on 2 ranks resumed (`--resume`)
against the uninterrupted 2-rank run; the one-rank `device_data_shard`
fallback; the refusals (a batch that does not divide by the ranks, too few
clips to shard, the 'model' axis); `distributed` and `mesh` in one process.
tests/test_torch_parallel_feeds.py and tests/test_torch_parallel_wav.py hold
the 2 ranks against `salsa_tpu`'s 2-device data mesh."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from salsa_tpu.data import dataset as jdataset  # noqa: E402
from salsa_tpu.data import transforms as jtransforms  # noqa: E402
from salsa_tpu.data.database import SplitData as JSplitData  # noqa: E402
from salsa_tpu.train import losses as jlosses  # noqa: E402
from salsa_tpu_torch.data import dataset as tdataset  # noqa: E402
from salsa_tpu_torch.data import transforms as ttransforms  # noqa: E402
from salsa_tpu_torch.data.database import SplitData  # noqa: E402
from salsa_tpu_torch.models.layers import batch_norm  # noqa: E402
from salsa_tpu_torch.models.seld import build_model  # noqa: E402
from salsa_tpu_torch.parallel import distributed, mesh  # noqa: E402
from salsa_tpu_torch.train import trainer as ttrainer  # noqa: E402
from salsa_tpu_torch.train.losses import accdoa_loss, seld_loss  # noqa: E402
from salsa_tpu_torch.utils.config import AttrDict  # noqa: E402
from tests.test_torch_resume import _write, corpus  # noqa: E402,F401 - the fixture
from tests.torch_parallel_worker import (  # noqa: E402
    DEC,
    ENC,
    N_CLASSES,
    bn_problem,
    feature_arrays,
    feature_config,
    launch,
    loss_problem,
)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cross_rank_batch_norm_equals_one_process_on_the_whole_batch(tmp_path):
    """Two ranks, 3 rows each: the output and the input's gradient of each row,
    the scale's and shift's gradients summed over the ranks (the trainer's
    all-reduce), and the running statistics after two steps equal one process's
    BatchNorm on the 6 rows within 1e-6; the ranks' statistics are equal, and a
    rank's own batch would give others."""
    ranks = launch({"mode": "bn"}, 2, str(tmp_path))
    x, gy = bn_problem()
    torch.manual_seed(0)
    bn = batch_norm(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    y.backward(torch.from_numpy(gy))
    bn(torch.from_numpy(x * 0.5 + 1.0))
    y = y.detach().numpy()
    for r in ranks:
        rows = slice(*r["rows"])
        np.testing.assert_allclose(r["y"], y[rows], atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(r["gx"], xt.grad.numpy()[rows], atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(r["running_mean"], bn.running_mean.numpy(), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(r["running_var"], bn.running_var.numpy(), atol=1e-6,
                                   rtol=1e-6)
    for k in ("gw", "gb"):
        np.testing.assert_allclose(np.sum([r[k] for r in ranks], axis=0),
                                   getattr(bn, "weight" if k == "gw" else "bias").grad.numpy(),
                                   atol=1e-5, rtol=1e-6)
    local = batch_norm(x.shape[1]).train()
    local(torch.from_numpy(x[:3]))
    assert not np.allclose(local.running_mean.numpy(), ranks[0]["running_mean"], atol=1e-3)


def test_global_loss_denominators(tmp_path):
    """reg_xyz and accdoa (silent-region term on) on a batch of 4 whose halves
    have mask masses far apart: the 2 ranks' losses add up to one process's loss
    on the whole batch (and salsa_tpu's), each rank's gradient is that loss's
    gradient on its rows, within 1e-6; the mean of the halves' own losses is
    not the global loss."""
    ranks = launch({"mode": "loss"}, 2, str(tmp_path))
    pred, target = loss_problem()
    sed = target["event_frame_gt"]
    assert sed[:2].sum() * 3 < sed[2:].sum()  # the halves' masses differ
    fns = {"reg_xyz": (lambda p, t: seld_loss(p, t, N_CLASSES),
                       lambda p, t: jlosses.seld_loss(p, t, N_CLASSES)),
           "accdoa": (lambda p, t: accdoa_loss(p, t, N_CLASSES, silent_weight=0.5),
                      lambda p, t: jlosses.accdoa_loss(p, t, N_CLASSES, silent_weight=0.5))}
    for name, (fn, jfn) in fns.items():
        p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in pred.items()}
        whole = fn(p, {k: torch.from_numpy(v) for k, v in target.items()})
        whole[0].backward()
        got = np.sum([r[name]["losses"] for r in ranks], axis=0)
        np.testing.assert_allclose(got, [float(v.detach()) for v in whole], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(got, [float(v) for v in jfn(pred, target)], rtol=1e-6,
                                   atol=1e-7)
        for r, rows in zip(ranks, (slice(0, 2), slice(2, 4))):
            for k, g in r[name]["grads"].items():
                np.testing.assert_allclose(g, p[k].grad.numpy()[rows], rtol=1e-6, atol=1e-9)
    # reg_xyz's DOA term divides by the mask mass: the halves' own means, averaged,
    # are not the global masked mean (accdoa's cell count is equal in the halves)
    halves = [float(seld_loss({k: torch.from_numpy(v[s]) for k, v in pred.items()},
                              {k: torch.from_numpy(v[s]) for k, v in target.items()},
                              N_CLASSES)[2]) for s in (slice(0, 2), slice(2, 4))]
    want = float(jlosses.seld_loss(pred, target, N_CLASSES)[2])
    assert abs(np.mean(halves) - want) > 0.05 * want


@pytest.mark.parametrize("n_ranks", [2, 3])
def test_process_shard_rows_bit_equal_to_salsa_tpu(n_ranks):
    """Each rank's batches (with salsa_tpu's FOA SALSA host transforms, the same
    generator seed on every rank) bit-equal to salsa_tpu's process_shard
    iterator's, the ranks' rows together the global batches' chunks; without
    drop_last, or with a batch that does not divide by the ranks, ValueError."""
    arrays = feature_arrays(n_clips=4, chunks_per_clip=4, chunk=16, label_chunk=8, n_feat=24)
    tsplit, jsplit = SplitData(**arrays), JSplitData(**arrays)
    batch = 6

    def batches(data_mod, transforms_mod, split, rank):
        joint, feat = transforms_mod.build_train_transforms(
            "salsa", "foa", N_CLASSES, 16, 24, rng=np.random.default_rng(5))
        ds = data_mod.SeldChunkDataset(split, joint, feat)
        return list(data_mod.batch_iterator(ds, batch, shuffle=True, rng=np.random.default_rng(8),
                                            drop_last=True, process_shard=(rank, n_ranks)))

    names = []
    for rank in range(n_ranks):
        got, want = batches(tdataset, ttransforms, tsplit, rank), batches(
            jdataset, jtransforms, jsplit, rank)
        assert len(got) == len(want) == 16 // batch
        for g, w in zip(got, want):
            assert g[3] == w[3] and g[4] == w[4] == batch // n_ranks
            for a, b in zip(g[:3], w[:3]):
                np.testing.assert_array_equal(a, b)
        names.append([g[3] for g in got])
    order = np.arange(16)
    np.random.default_rng(8).shuffle(order)
    for s in range(16 // batch):
        rows = sum((names[r][s] for r in range(n_ranks)), [])
        assert rows == [tsplit.clip_names[j] for j in order[s * batch:(s + 1) * batch]]
    ds = tdataset.SeldChunkDataset(tsplit)
    with pytest.raises(ValueError, match="drop_last"):
        next(tdataset.batch_iterator(ds, batch, process_shard=(0, n_ranks)))
    with pytest.raises(ValueError, match="divides"):
        next(tdataset.batch_iterator(ds, 7, drop_last=True, process_shard=(0, n_ranks)))


def test_two_ranks_equal_one_rank_with_dropout_and_augmentation(tmp_path):
    """The resident path with dropout (0.2 on the heads and between the GRU
    layers, 0.1 in the residual blocks) and the device augmentation drawn from
    the port's generators: 2 ranks of 2 rows take the steps 1 rank of 4 takes
    (every rank draws the global batch's masks and keeps its rows), within
    rtol 1e-5 a step over 4 steps; every rank ends with the same weights."""
    spec = dict(mode="device_data", seed=3, epochs=2, workdir=str(tmp_path), dropout=True,
                augment=True)
    one, two = launch(spec, 1, str(tmp_path))[0], launch(spec, 2, str(tmp_path))
    assert one["n_ranks"] == 1 and [r["n_ranks"] for r in two] == [2, 2]
    assert two[0]["weights"] == two[1]["weights"]
    np.testing.assert_allclose(two[0]["step_losses"], one["step_losses"], rtol=1e-5)
    w1, w2 = one["weights"], two[0]["weights"]
    np.testing.assert_allclose([w2[k] for k in w1], [w1[k] for k in w1], rtol=1e-4, atol=1e-4)
    plain = launch(dict(spec, dropout=False, augment=False), 1, str(tmp_path))[0]
    assert not np.allclose(plain["step_losses"], one["step_losses"], rtol=1e-3)


def test_cli_train_resumes_on_two_ranks(corpus, tmp_path):
    """cli.train from wav on 2 ranks (torchrun's variables; batch 2, one row a
    rank; dropout and the device augmentation on; rank 0 validates and writes
    the checkpoints) for 3 epochs, against 1 epoch and then `--resume` (the
    SALSA_* variables) to 3 epochs: the checkpoints' epoch losses equal, and the
    optimizer's count is the uninterrupted run's on both ranks."""
    config = _write(corpus, "parallel_resume.yml", device_augment=True, max_epochs=3)
    runs = {}
    for name, phases in (("whole", [(3, False, "torchrun")]),
                         ("resumed", [(1, False, "torchrun"), (3, True, "salsa")])):
        group = str(tmp_path / name)
        for epochs, resume, launcher in phases:
            outs = launch({"mode": "cli", "config": config, "group": group, "resume": resume,
                           "overrides": [f"training.max_epochs={epochs}"]}, 2, str(tmp_path),
                          launcher=launcher)
        assert [o["rank"] for o in outs] == [0, 1] and outs[0]["count"] == outs[1]["count"]
        runs[name] = outs[0]
    assert runs["resumed"]["count"] == runs["whole"]["count"] == 3 * runs["whole"][
        "steps_per_epoch"]
    np.testing.assert_allclose(runs["resumed"]["epoch_losses"], runs["whole"]["epoch_losses"],
                               rtol=1e-6)


def test_device_data_shard_on_one_rank_is_device_data(tmp_path):
    """At one rank device_data_shard falls back to device_data, as in salsa_tpu:
    nothing is sharded and the steps are device_data's, bit for bit."""
    runs = []
    for mode in ("shard", "device_data"):
        tr = ttrainer.SeldTrainer(model=build_model(encoder=ENC, decoder=DEC,
                                                    n_classes=N_CLASSES),
                                  cfg=AttrDict(feature_config(mode, epochs=1)),
                                  train_data=SplitData(**feature_arrays()), val_data=None,
                                  gt_meta_dir=None, submission_dir=str(tmp_path), seed=3,
                                  device="cpu")
        assert not tr.device_data_shard and tr._feats_shard is None and tr.device_data
        tr.train_epoch(0)
        runs.append(tr.step_losses)
    assert runs[0] == runs[1]


def test_refusals(monkeypatch, tmp_path):
    """A batch that does not divide by the ranks and a split of fewer clips than
    ranks raise ValueError before any collective; the 'model' axis raises
    NotImplementedError."""
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        mesh.data_width(5, 2)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="train_batch_size 5 not divisible by 2 processes"):
        ttrainer.SeldTrainer(model=build_model(encoder=ENC, decoder=DEC, n_classes=N_CLASSES),
                             cfg=AttrDict(feature_config("host", batch=5)),
                             train_data=SplitData(**feature_arrays()), val_data=None,
                             gt_meta_dir=None, submission_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        distributed.local_batch_slice(5)
    monkeypatch.setattr(mesh, "replicate", lambda m: m)  # no process group in this test
    with pytest.raises(ValueError, match="at least 2 clips"):
        ttrainer.SeldTrainer(model=build_model(encoder=ENC, decoder=DEC, n_classes=N_CLASSES),
                             cfg=AttrDict(feature_config("shard")),
                             train_data=SplitData(**feature_arrays(n_clips=1, chunks_per_clip=8)),
                             val_data=None, gt_meta_dir=None, submission_dir=str(tmp_path),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="'model' mesh axis"):
        mesh.param_sharding(2)
    mesh.param_sharding(1)


def test_distributed_and_mesh_in_one_process(monkeypatch):
    """Without a launcher's variables initialize() forms nothing and every helper
    is the one-process identity; the shard helpers split rows as salsa_tpu's
    shard_global does (zero rows padding the last rank)."""
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "SALSA_COORDINATOR", "SALSA_NUM_PROCESSES",
              "SALSA_PROCESS_ID", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False and not distributed.is_initialized()
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)
    assert distributed.is_primary() and distributed.local_batch_slice(6) == slice(0, 6)
    t = torch.arange(3.0)
    assert distributed.all_reduce_sum(t) is t and torch.equal(t, torch.arange(3.0))
    assert distributed.gather_objects({"a": 1}) == [{"a": 1}]
    distributed.barrier("single")
    assert distributed.local_device() == (torch.device("cuda", 0) if torch.cuda.is_available()
                                          else torch.device("cpu"))
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.local_rank() == 3
    assert distributed.default_backend(2) == ("gloo" if not torch.cuda.is_available()
                                              or torch.cuda.device_count() < 2 else "nccl")
    monkeypatch.setenv("SALSA_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="SALSA_COORDINATOR"):
        distributed.initialize()
    x = np.arange(5 * 2).reshape(5, 2)
    assert mesh.shard_rows(5, 2) == (3, 6)
    np.testing.assert_array_equal(mesh.shard_global(x, 0, 2), x[:3])
    np.testing.assert_array_equal(mesh.shard_global(x, 1, 2), np.concatenate([x[3:], [[0, 0]]]))
    assert mesh.data_width(8, 4) == 4
    m = torch.nn.Linear(2, 2)
    assert mesh.replicate(m) is m

