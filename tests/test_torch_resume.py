"""Resuming the port's trainer on the CPU: k steps, a checkpoint, a restore in a
fresh trainer and m more steps equal k + m uninterrupted steps bit for bit, with
augmentation and dropout on, for Adam and AdamW (every step's draws are a function
of (seed, step)); `cli.train --resume` continues at the epoch after the one its
latest checkpoint recorded, and refuses a checkpoint without optimizer state; and
a checkpoint that `salsa_tpu`'s trainer wrote after k steps resumes in the port,
whose next m losses stay within 3.8e-5 of `salsa_tpu`'s own (dropout 0, no
augmentation: the two packages' draws differ)."""
import os
import pathlib
import re
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import yaml  # noqa: E402

from salsa_tpu.train import checkpoint as jckpt  # noqa: E402
from salsa_tpu.utils.audio_io import write_wav  # noqa: E402
from salsa_tpu_torch.cli import train as cli_train  # noqa: E402
from salsa_tpu_torch.interop import torch_state_dict_to_flax  # noqa: E402
from salsa_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from salsa_tpu_torch.train.state import make_optimizer  # noqa: E402
from tests.test_from_wav import _synth_wave_8k  # noqa: E402
from tests.test_torch_cli_train import FS, N_CLASSES, TRAIN, VAL, _config  # noqa: E402
from tests.test_torch_trainer import train_both  # noqa: E402


@pytest.fixture
def scratch():
    """A temporary directory removed after the test: its full-width checkpoints
    (135 MB each with Adam's moments) would otherwise stay in the temp trees that
    pytest keeps from its last runs, and fill the disk."""
    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """2 s clips at 8 kHz with DCASE metadata and train/val splits."""
    root = str(tmp_path_factory.mktemp("torch_resume"))
    rng = np.random.default_rng(20261021)
    for sub in ("foa_dev", "metadata_dev", "meta"):
        os.makedirs(os.path.join(root, sub))
    for i, name in enumerate(TRAIN + VAL):
        write_wav(os.path.join(root, "foa_dev", name + ".wav"), _synth_wave_8k(rng, 2.0), FS,
                  bits=16)
        rows = [f"{f},{(f + i) % N_CLASSES},0,{(f * 11) % 360 - 180},{(f * 5) % 60 - 30}"
                for f in range(4, 16)]
        with open(os.path.join(root, "metadata_dev", name + ".csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    for split, names in (("train", TRAIN), ("val", VAL)):
        with open(os.path.join(root, "meta", f"{split}.csv"), "w") as f:
            f.write("filename\n" + "\n".join(names))
    return root


def _write(root, name, **training):
    """An experiment config: the cli.train tests' (batch 2, constant lr 1e-3,
    dropout 0.2 on the heads and 0.3 between the GRU layers), 2 steps an epoch."""
    cfg = _config(root, **training)
    cfg["data"]["train_fraction"] = 0.7
    path = os.path.join(root, name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


def _weights(tr):
    return {k: v.detach().clone() for k, v in tr.model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_resume_equals_uninterrupted_steps(corpus, scratch, optimizer):
    """1 epoch (2 steps), the checkpoint, a fresh trainer restored from it and 2
    more epochs equal 3 uninterrupted epochs bit for bit: every step's loss, every
    weight and statistic, Adam's moments. Augmentation (the full stack: FOA
    swaps, shift) and dropout are on, and their draws change the batch."""
    config = _write(corpus, f"resume_{optimizer}.yml", device_augment=True, max_epochs=3,
                    optimizer=optimizer)
    group = str(scratch / "outputs")
    build = lambda: cli_train.build_trainer(config, group, device="cpu")  # noqa: E731

    whole = build()
    assert whole.augment is not None and whole.steps_per_epoch == 2
    ids = whole._epoch_order(0)[:whole.batch_size]
    whole.seed_step()
    x, sed, doa = whole.batch(ids)
    ax, _, adoa = whole.augment_batch(x, sed, doa)
    assert not torch.equal(ax, x) or not torch.equal(adoa, doa)
    losses = []
    for epoch in range(3):
        whole.train_epoch(epoch)
        losses.append(whole.step_losses)

    first = build()
    first.train_epoch(0)
    assert first.step_losses == losses[0]
    path = first.save(str(scratch / "ck"), "epoch000", {"epoch": 0})

    resumed = build()
    assert resumed.restore(path) == 1 and resumed.optimizer.count == 2
    for k, v in _weights(first).items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    got = []
    for epoch in (1, 2):
        resumed.train_epoch(epoch)
        got.append(resumed.step_losses)
    assert got == losses[1:]
    want = _weights(whole)
    for k, v in _weights(resumed).items():
        assert torch.equal(v, want[k]), k
    opt_w, opt_r = whole.optimizer.optimizer, resumed.optimizer.optimizer
    for pw, pr in zip(whole.model.parameters(), resumed.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt_w.state[pw][key], opt_r.state[pr][key]), key
    assert (resumed.optimizer.lr, resumed.optimizer.b1) == (whole.optimizer.lr,
                                                             whole.optimizer.b1)


def test_cli_resume_continues_at_the_sidecar_epoch(corpus, scratch, monkeypatch):
    """cli.train for 1 epoch, then resumed with max_epochs 3: it restores epoch000
    (logged), trains epochs 1 and 2 only, and ends where a fresh 3-epoch run ends
    (constant lr, so the total step count does not enter the schedule), bit for
    bit. `--resume` is what sets `resume` (the CLI runs on the card, so the CPU
    runs call `train`)."""
    config = _write(corpus, "cli_resume.yml", device_augment="feature", max_epochs=1)
    group = str(scratch / "outputs")
    cli_train.train(config, group, device="cpu")
    tr = cli_train.train(config, group, device="cpu", resume=True,
                         overrides=["training.max_epochs=3"])
    exp = os.path.join(group, "crossval", "foa", "salsa", "cli_resume")
    with open(os.path.join(exp, "logs", "log.txt")) as f:
        log = f.read()
    assert re.search(r"Resumed from \S+epoch000\.msgpack at step 2 \(epoch 1\)", log)
    assert re.findall(r"Epoch (\d)/(\d) - loss", log) == [("0", "0"), ("1", "2"), ("2", "2")]
    assert sorted(os.listdir(os.path.join(exp, "models", "checkpoint"))) == [
        f"epoch{e:03d}.{x}" for e in range(3) for x in ("json", "msgpack")]
    fresh = cli_train.train(config, str(scratch / "fresh"), device="cpu",
                            overrides=["training.max_epochs=3"])
    assert tr.optimizer.count == fresh.optimizer.count == 6
    assert tr.step_losses == fresh.step_losses
    want = _weights(fresh)
    for k, v in _weights(tr).items():
        assert torch.equal(v, want[k]), k
    calls = []
    monkeypatch.setattr(cli_train, "train", lambda *a, **kw: calls.append(kw))
    cli_train.main(["--exp-config", config, "--exp-group-dir", group, "--resume"])
    cli_train.main(["--exp-config", config, "--exp-group-dir", group])
    assert [kw["resume"] for kw in calls] == [True, False]


def test_resume_refuses_a_checkpoint_without_optimizer_state(corpus, scratch):
    config = _write(corpus, "no_opt.yml", max_epochs=1)
    group = str(scratch / "outputs")
    tr = cli_train.train(config, group, device="cpu")
    # the latest checkpoint (by step) is one saved without the optimizer's state
    save_checkpoint(tr.cfg.dir.model.checkpoint, "epoch009",
                    *torch_state_dict_to_flax(tr.model.state_dict()), 99, {"epoch": 9})
    with pytest.raises(ValueError, match="no optimizer state"):
        cli_train.train(config, group, device="cpu", resume=True)


def test_load_optax_state_refuses_a_foreign_tree(corpus, tmp_path):
    """A tree of the other optimizer, or moments of another network, is refused."""
    tr = cli_train.build_trainer(_write(corpus, "foreign.yml", max_epochs=1),
                                 str(tmp_path / "outputs"), device="cpu")
    state = tr.optimizer.optax_state(tr.model)
    adamw = make_optimizer(tr.model.parameters(), 4, "adamw")
    with pytest.raises(ValueError, match="adamw"):
        adamw.load_optax_state(tr.model, state)
    mu = state["inner_state"]["0"]["mu"]
    mu["decoder"].pop("event_fc1")
    with pytest.raises(ValueError, match="mu does not match"):
        tr.optimizer.load_optax_state(tr.model, state)


K_STEPS, M_STEPS = 3, 3


def test_salsa_tpu_checkpoint_resumes_in_the_port(scratch):
    """salsa_tpu's trainer after 3 steps (one an epoch) writes its checkpoint; the
    port's trainer restores it and takes 3 more steps, whose losses stay within
    3.8e-5 of salsa_tpu's own steps 4-6 (dropout 0 in both, no augmentation)."""
    both = train_both(str(scratch), n_steps=K_STEPS)
    run = next(both)
    try:
        jt, tt = run["jax"], run["torch"]
        path = jckpt.save_checkpoint(str(scratch / "jax_ck"), f"epoch{K_STEPS - 1:03d}",
                                     jax.device_get(jt.state), {"epoch": K_STEPS - 1})
        want = [jt.train_epoch(e)["loss"] for e in range(K_STEPS, K_STEPS + M_STEPS)]
        assert tt.restore(path) == K_STEPS and tt.optimizer.count == K_STEPS
        got = [tt.train_epoch(e)["loss"] for e in range(K_STEPS, K_STEPS + M_STEPS)]
        np.testing.assert_allclose(got, want, rtol=3.8e-5)
        assert np.std(got) > 0  # the steps see different batches
    finally:
        both.close()
