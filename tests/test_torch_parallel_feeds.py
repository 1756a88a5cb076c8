"""The port's data-parallel trainer on 2 gloo ranks against `salsa_tpu`'s
SeldTrainer on a 2-device data mesh (`make_mesh(n_data=2)`, 2 of the 8 virtual
CPU devices), on one feature-level problem (tests/torch_parallel_worker.py:
8 clips of 4 chunks, 7 x 64 x 32 windows, batch 4 = 2 rows a rank, one step an
epoch) from one flax init: the host-fed path, `training.device_data`,
`training.device_data_shard` (the stratified order, each rank holding its 4
clips), and the resident path with dropout and the device augmentation on. Both
packages' dropout masks are then one fixed function of each element's logical
coordinates (`torch_parallel_worker.logical_keep`; their random draws differ),
and the port's augmentation draws are `salsa_tpu`'s key tree replayed for the
step (its trainer given a threefry key). Step 1's loss agrees within rtol 1e-4
and every step's within 2e-3, the bounds of tests/test_multihost.py. Then
`fit` on 2 ranks, stopped after epoch 0 and resumed from its checkpoint by a
fresh pair of ranks, against `salsa_tpu`'s uninterrupted run.
"""
import importlib
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from salsa_tpu.data.database import SplitData as JSplitData  # noqa: E402
from salsa_tpu.models.seld import build_model as j_build_model  # noqa: E402
from salsa_tpu.parallel.mesh import make_mesh, replicate  # noqa: E402
from salsa_tpu.train.trainer import SeldTrainer as JTrainer  # noqa: E402
from salsa_tpu.utils.config import AttrDict as JAttrDict  # noqa: E402
from salsa_tpu_torch.interop import flax_to_torch_state_dict  # noqa: E402
from tests.torch_parallel_worker import (  # noqa: E402
    DEC,
    DEC_DROPOUT,
    ENC,
    N_CLASSES,
    feature_arrays,
    feature_config,
    launch,
    logical_keep,
)

jdropout = importlib.import_module("salsa_tpu.ops.dropout")
SEED, N_STEPS = 3, 4


def position_dropout(x, key, rate):
    """salsa_tpu's dropout with the logical-coordinate mask (NHWC)."""
    keep = jnp.asarray(logical_keep(x.shape, "nhwc"))
    return jnp.where(keep, x * jnp.asarray(1.0 / (1.0 - rate), x.dtype), jnp.zeros((), x.dtype))


def jax_reference(tmp, mode, dropout=False, augment=False, n_steps=N_STEPS):
    """salsa_tpu's losses, one step an epoch, on the 2-device data mesh, and the
    path of its flax init as torch-named weights."""
    cfg = feature_config(mode, epochs=n_steps, augment=augment, train_fraction=0.125)
    patch = pytest.MonkeyPatch()
    if dropout:
        patch.setattr(jdropout, "dropout", position_dropout)
    try:
        jt = JTrainer(model=j_build_model(encoder=ENC, decoder=DEC_DROPOUT if dropout else DEC,
                                          n_classes=N_CLASSES),
                      cfg=JAttrDict(cfg), train_data=JSplitData(**feature_arrays()),
                      val_data=None, gt_meta_dir=None, submission_dir=str(tmp),
                      mesh=make_mesh(n_data=2), seed=SEED)
        assert jt.mesh.shape["data"] == 2 and jt.device_data_shard == (mode == "shard")
        jt.state = jt.state.replace(step=replicate(jt.mesh, jnp.asarray(0, jnp.int32)))
        if augment:
            jt._dropout_rng = jax.random.PRNGKey(SEED)  # replayed by the port's ranks
        init = os.path.join(str(tmp), f"init_{mode}.npz")
        np.savez(init, **flax_to_torch_state_dict(
            *jax.device_get((jt.state.params, jt.state.batch_stats))))
        losses = [float(jt.train_epoch(e)["loss"]) for e in range(n_steps)]
    finally:
        patch.undo()
    return losses, init


def port_losses(tmp, mode, init, n_ranks=2, **spec):
    outs = launch(dict(mode=mode, seed=SEED, epochs=N_STEPS, workdir=str(tmp), init=init,
                       train_fraction=0.125, max_epochs=N_STEPS, **spec), n_ranks, str(tmp))
    assert [o["rank"] for o in outs] == list(range(n_ranks))
    assert all(o["step_losses"] == outs[0]["step_losses"] for o in outs)  # global losses
    assert all(o["weights"] == outs[0]["weights"] for o in outs)  # one Adam step on every rank
    return outs[0]["step_losses"]


def assert_traces_match(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert len(got) == len(want) and np.isfinite(got).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, err_msg=f"{got} vs {want}")
    np.testing.assert_allclose(got, want, rtol=2e-3, err_msg=f"{got} vs {want}")
    assert np.std(got) > 1e-3  # the steps see different batches and weights


_refs: dict = {}


def reference(tmp_factory, mode, dropout=False, augment=False):
    """jax_reference, cached for the module (one salsa_tpu compile a path)."""
    key = (mode, dropout, augment)
    if key not in _refs:
        _refs[key] = jax_reference(tmp_factory.mktemp("jax"), mode, dropout, augment)
    return _refs[key]


@pytest.mark.parametrize("mode", ["host", "device_data"])
def test_feeds_match_salsa_tpu(tmp_path_factory, tmp_path, mode):
    """Both feeds take the same batches (the epoch order of (seed, epoch)), so
    both match salsa_tpu's host-fed run."""
    want, init = reference(tmp_path_factory, "host")
    assert_traces_match(port_losses(tmp_path, mode, init), want)


def test_device_data_shard_matches_salsa_tpu(tmp_path_factory, tmp_path):
    want, init = reference(tmp_path_factory, "shard")
    assert_traces_match(port_losses(tmp_path, "shard", init), want)
    plain, _ = reference(tmp_path_factory, "host")
    assert not np.allclose(want, plain, rtol=1e-3)  # the stratified order is another order


def test_dropout_and_device_augment_match_salsa_tpu(tmp_path_factory, tmp_path):
    want, init = reference(tmp_path_factory, "device_data", dropout=True, augment=True)
    got = port_losses(tmp_path, "device_data", init, dropout=True, augment=True,
                      position_dropout=True, replay_augment=True)
    assert_traces_match(got, want)
    plain, _ = reference(tmp_path_factory, "host")
    assert not np.allclose(want, plain, rtol=1e-3)  # the masks and draws change the steps


def test_resume_on_two_ranks_matches_salsa_tpu(tmp_path_factory, tmp_path):
    """`fit` on 2 ranks for 2 epochs (rank 0 writes each epoch's checkpoint), then
    a fresh pair of ranks resumed from epoch001 to 4 epochs: the 4 sidecars'
    losses against salsa_tpu's uninterrupted 4 steps."""
    want, init = reference(tmp_path_factory, "host")
    spec = dict(mode="host", seed=SEED, workdir=str(tmp_path), init=init, train_fraction=0.125,
                fit=True)
    first = launch(dict(spec, max_epochs=2), 2, str(tmp_path))
    assert first[0]["count"] == first[1]["count"] == 2
    second = launch(dict(spec, max_epochs=N_STEPS, resume=True), 2, str(tmp_path),
                    launcher="salsa")
    assert second[0]["count"] == second[1]["count"] == N_STEPS
    assert_traces_match(second[0]["epoch_losses"], want)
