"""EINV2 in the port (`models.encoders.EINV2Encoder`, `models.decoders.EINV2Decoder`,
the `tracks` output format, `train.losses.tpit_loss`, the track-wise labels and
CSVs) against the plain reference `seldbench/reference/einv2.py`, on seeded
weights mapped as the benchmark's `serve_tracks` driver maps them, at 2 clips x
1 s of SALSA-FOA features (7 x 81 x 200); and EINV2 through `cli.train`,
`cli.predict` and `cli.infer` on a small corpus."""
import glob
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from salsa_tpu_torch.data.database import classwise_targets, trackwise_targets  # noqa: E402
from salsa_tpu_torch.metrics.dcase_io import load_output_csv, xyz_to_polar_deg  # noqa: E402
from salsa_tpu_torch.models.decoders import EINV2Decoder  # noqa: E402
from salsa_tpu_torch.models.layers import Dropout, SelfAttention  # noqa: E402
from salsa_tpu_torch.models.seld import build_model  # noqa: E402
from salsa_tpu_torch.pipeline import heads  # noqa: E402
from salsa_tpu_torch.train.losses import tpit_loss  # noqa: E402
from salsa_tpu_torch.submission import write_trackwise_csv  # noqa: E402
from salsa_tpu_torch.utils import profiling  # noqa: E402
from seldbench.drivers.serve_tracks import weights as driver_weights  # noqa: E402
from seldbench.manifest import Manifest  # noqa: E402
from seldbench.reference import einv2 as ref  # noqa: E402
from seldbench.work_einv2 import einv2_flops  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "salsa_tpu_torch", "recipes", "einv2.yml")
SHAPE = (2, 7, 81, 200)  # 2 clips x 1 s of SALSA-FOA features
N_CLASSES = 12


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads, as the other CPU files take beside the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model():
    with open(RECIPE) as f:
        m = yaml.safe_load(f)["model"]
    return build_model(m["encoder"], m["decoder"], N_CLASSES, "tracks")


@pytest.fixture(scope="module")
def setup():
    """The recipe's model with the driver's seeded weights, eval mode, its weights
    as the reference takes them, and seeded features."""
    model = _model()
    w = driver_weights(model, 20261019, torch.device("cpu"))
    model.load_state_dict(w)
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(7))
    return model.eval(), w, x


def _targets(g, B, T, K=3, C=N_CLASSES):
    """Seeded track targets: each track of each frame active with one class or empty."""
    active = torch.rand((B, T, K), generator=g) < 0.6
    cls = torch.randint(0, C, (B, T, K), generator=g)
    sed = torch.nn.functional.one_hot(cls, C).float() * active[..., None]
    xyz = torch.nn.functional.normalize(torch.randn((B, T, K, 3), generator=g), dim=-1)
    return sed, xyz * active[..., None]


def test_parameter_count_and_shapes(setup):
    model, _, x = setup
    assert sum(p.numel() for p in model.parameters()) == 34_635_757
    with torch.no_grad():
        out = model(x)
    assert out["event_frame_logit"].shape == (2, 20, 3, N_CLASSES)
    assert out["doa_frame_output"].shape == (2, 20, 3, 3)


def test_checkpoint_tree_is_the_callers_choice(setup):
    """EINV2 has no flax counterpart: its checkpoint is the `torch` tree, which
    `flax_to_torch_state_dict` reads back name for name; the flax path refuses its
    names rather than guessing the format from them."""
    from salsa_tpu_torch.interop import flax_to_torch_state_dict, torch_state_dict_to_flax

    model, _, _ = setup
    assert not model.flax_counterpart
    sd = model.state_dict()
    params, stats = torch_state_dict_to_flax(sd, torch_tree=not model.flax_counterpart)
    back = flax_to_torch_state_dict(params, stats)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
    with pytest.raises(ValueError):
        torch_state_dict_to_flax(sd)


def test_eval_outputs_equal_the_reference(setup):
    model, w, x = setup
    with torch.no_grad():
        out = model(x)
        event, doa = ref.Forward(w)(x)
    torch.testing.assert_close(out["event_frame_logit"], event, rtol=0, atol=2e-5)
    torch.testing.assert_close(out["doa_frame_output"], doa, rtol=0, atol=2e-5)
    prob, xyz = heads(out["event_frame_logit"], out["doa_frame_output"], 0.5, N_CLASSES,
                      "tracks")
    ref_prob, ref_xyz = ref.serve(w, x)
    assert prob.shape == ref_prob.shape == (2, 10, 3, N_CLASSES)
    torch.testing.assert_close(prob, ref_prob, rtol=0, atol=1e-5)
    torch.testing.assert_close(xyz, ref_xyz, rtol=0, atol=1e-5)


def _train_both(model, w, x, seed):
    """The port's training-mode forward and tPIT loss with autograd, and the
    reference's on the same dropout draws: ((port event, doa, losses, grads),
    (reference ...), the reference's moved statistics)."""
    shared = torch.Generator().manual_seed(seed)  # every dropout's, as in the trainer
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = shared
    model.load_state_dict(w)
    model.train()
    model.zero_grad()
    out = model(x)
    B, T = out["event_frame_logit"].shape[:2]
    sed, doa = (t.to(x.dtype) for t in _targets(torch.Generator().manual_seed(seed + 1), B, T))
    losses = tpit_loss(out["event_frame_logit"], out["doa_frame_output"], sed, doa, (0.5, 0.5))
    losses[0].backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    port = (out["event_frame_logit"].detach(), out["doa_frame_output"].detach(),
            [float(v.detach()) for v in losses], grads,
            {k: v.clone() for k, v in model.state_dict().items()})
    model.load_state_dict(w)
    model.eval()

    g = torch.Generator().manual_seed(seed)
    leaves = {k: v.clone().requires_grad_(k in grads) for k, v in w.items()}
    fwd = ref.Forward(leaves, draw=lambda shape: torch.rand(shape, generator=g))
    event, xyz = fwd(x)
    r_losses = ref.tpit(event, xyz, sed, doa, (0.5, 0.5))
    r_losses[0].backward()
    reference = (event.detach(), xyz.detach(), [float(v.detach()) for v in r_losses],
                 {k: leaves[k].grad for k in grads})
    return port, reference, fwd.stats


# (seed, dtype, tolerance): float64 holds the arithmetic alike to rounding; in float32
# BatchNorm's batch statistics over 2 clips round the gradients differently by up to
# ~0.7 % of a leaf's norm, so they are compared by norm there
@pytest.mark.parametrize("seed,dtype,tol", [(3, torch.float64, 1e-9), (11, torch.float32, 5e-5)])
def test_training_mode_loss_and_gradients_equal_the_reference(setup, seed, dtype, tol):
    model, w, x = setup
    w = {k: v.to(dtype) if v.is_floating_point() else v for k, v in w.items()}
    model = model.to(dtype)
    try:
        (ev, doa, losses, grads, state), (r_ev, r_doa, r_losses, r_grads), stats = _train_both(
            model, w, x.to(dtype), seed)
    finally:
        model.float()
    torch.testing.assert_close(ev, r_ev, rtol=0, atol=tol)
    torch.testing.assert_close(doa, r_doa, rtol=0, atol=tol)
    np.testing.assert_allclose(losses, r_losses, rtol=1e-12 if dtype == torch.float64 else 1e-5)
    for k, v in stats.items():  # the moved running statistics, which the port sums in float32
        torch.testing.assert_close(state[k], v, rtol=1e-4, atol=1e-5, msg=k)
    norms = {k: float(g.norm()) for k, g in r_grads.items()}
    median = float(np.median(list(norms.values())))
    assert min(norms.values()) > 0
    for k, g in grads.items():
        gap = float((g - r_grads[k]).norm()) / max(norms[k], median)
        assert gap < (1e-6 if dtype == torch.float64 else 2e-2), (k, gap)


def test_identity_stitches_leave_the_branches_apart(setup):
    """With every cross-stitch unit the identity, the SED outputs read channels 0-3
    alone; the driver's units couple them to the spatial channels 4-6."""
    model, w, x = setup
    moved = x.clone()
    moved[:, 4:] += 1.0
    identity = dict(w)
    for k in [k for k in w if k.endswith("alpha")]:
        identity[k] = torch.eye(2).expand(w[k].shape).clone()
    for weights, coupled in ((identity, False), (w, True)):
        model.load_state_dict(weights)
        with torch.no_grad():
            a, b = model(x), model(moved)
        gap = (a["event_frame_logit"] - b["event_frame_logit"]).abs().max()
        assert (gap > 1e-2) if coupled else (gap == 0), gap
        assert (a["doa_frame_output"] - b["doa_frame_output"]).abs().max() > 1e-2
    model.load_state_dict(w)


def test_outputs_follow_the_input(setup):
    """Not vacuous under the driver's weights: a loud event on the spectrogram
    channels from frame 40 on, or a shift of the spatial channels, moves the
    answers, which spread over (0, 1) and the sphere, not held by BatchNorm's
    shifts."""
    _, w, x = setup
    loud, turned = x.clone(), x.clone()
    loud[:, :4, 40:] += 2.0
    turned[:, 4:, 40:] += 0.5
    with torch.no_grad():
        p, d = ref.serve(w, x)
        for other, least in ((loud, (0.02, 0.05)), (turned, (2e-3, 5e-3))):
            p2, d2 = ref.serve(w, other)
            assert (p - p2).abs().mean() > least[0] and (d - d2).abs().mean() > least[1]
    assert 0.05 < float(p.std()) and 0.1 < float(d.std())
    assert 0.02 < float(p.min()) and float(p.max()) < 0.98


def _frame_losses(logit, doa, sed_gt, doa_gt, w):
    """The six permutations' losses of one frame, written out."""
    out = []
    for perm in itertools.permutations(range(3)):
        bce = mse = 0.0
        for k, j in enumerate(perm):
            p = torch.sigmoid(logit[k])
            bce += float(-(sed_gt[j] * torch.log(p) + (1 - sed_gt[j]) * torch.log(1 - p)).mean())
            mse += float(sed_gt[j].max()) * float(((doa[k] - doa_gt[j]) ** 2).mean())
        out.append(w[0] * bce / 3 + w[1] * mse / 3)
    return out


def test_tpit_is_the_least_permutation_and_invariant():
    g = torch.Generator().manual_seed(5)
    B, T = 2, 6
    logit = torch.randn((B, T, 3, N_CLASSES), generator=g)
    doa = torch.tanh(torch.randn((B, T, 3, 3), generator=g))
    sed, xyz = _targets(g, B, T)
    w = (0.4, 0.6)
    total = float(tpit_loss(logit, doa, sed, xyz, w)[0])
    want = np.mean([min(_frame_losses(logit[b, t], doa[b, t], sed[b, t], xyz[b, t], w))
                    for b in range(B) for t in range(T)])
    assert total == pytest.approx(want, rel=1e-5)
    perm = torch.stack([torch.randperm(3, generator=g) for _ in range(B * T)]).view(B, T, 3)
    shuffled = (torch.gather(sed, 2, perm[..., None].expand_as(sed)),
                torch.gather(xyz, 2, perm[..., None].expand_as(xyz)))
    assert float(tpit_loss(logit, doa, *shuffled, w)[0]) == pytest.approx(total, rel=1e-6)
    # padded rows out of the mean: only row 0's frames count
    row = torch.tensor([1.0, 0.0])
    row0 = float(tpit_loss(logit[:1], doa[:1], sed[:1], xyz[:1], w)[0])
    assert float(tpit_loss(logit, doa, sed, xyz, w, row_weights=row)[0]) == pytest.approx(row0)


def test_trackwise_targets_keep_same_class_overlaps():
    rows = np.array([[0, 1, 0, 10, 0], [0, 1, 1, -90, 20],            # class 1 twice
                     [1, 2, 5, 0, 0], [1, 0, 4, 180, -30], [1, 1, 3, 45, 0],
                     [1, 3, 7, 90, 0],                                 # a 4th event
                     [3, 0, 2, 0, 90], [9, 0, 0, 0, 0]], dtype=np.float64)
    sed, doa, dropped = trackwise_targets(rows, 5, 4)
    assert sed.shape == (5, 3, 4) and doa.shape == (5, 3, 3) and dropped == 1
    assert sed[0, 0, 1] == sed[0, 1, 1] == 1 and sed[0].sum() == 2
    # frame 1 in ascending metadata-track order: 3 (class 1), 4 (class 0), 5 (class 2)
    assert [int(np.argmax(sed[1, k])) for k in range(3)] == [1, 0, 2]
    np.testing.assert_allclose(doa[0, 1], [0.0, -np.cos(np.deg2rad(20)), np.sin(np.deg2rad(20))],
                               atol=1e-6)
    np.testing.assert_allclose(doa[3, 0], [0, 0, 1], atol=1e-6)
    assert sed[2].sum() == sed[4].sum() == 0 and not doa[2].any()
    assert np.allclose(np.linalg.norm(doa[sed.max(-1) > 0], axis=-1), 1)
    classwise, _ = classwise_targets(rows, 5, 4)
    assert classwise[0].sum() == 1  # the class-wise table merges the overlap


def test_trackwise_csv_round_trips(tmp_path):
    g = np.random.default_rng(3)
    prob = g.uniform(size=(12, 3, 4)).astype(np.float32)
    prob[2, :, 1] = 0.9  # one class on all three tracks
    xyz = g.normal(size=(12, 3, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    path = str(tmp_path / "clip.csv")
    write_trackwise_csv(path, prob, xyz, 4, sed_threshold=0.5, max_frames=10)
    events = load_output_csv(path, "2021")
    azi, ele = xyz_to_polar_deg(xyz[..., 0], xyz[..., 1], xyz[..., 2])
    want = {}
    for f, k, c in zip(*np.nonzero(prob[:10] >= 0.5)):
        a = int(np.around(azi[f, k]))
        want.setdefault(int(f), []).append([int(c), -180 if a == 180 else a,
                                            int(np.around(ele[f, k])), int(k)])
    assert {f: [[int(v) for v in row] for row in rows] for f, rows in events.items()} == want
    assert len(events[2]) >= 3


def test_a_forward_records_its_spans_and_counters(setup):
    model, _, x = setup
    frames, scores = EINV2Decoder.stack_frames, SelfAttention.score_elements
    profiling.reset_spans()
    with torch.no_grad():
        model(x)
    counts = {k: n for k, (n, _) in profiling.span_totals().items()}
    assert counts == {"model.stitch": 3, "model.attention": 12, "model.decoder": 1}
    assert EINV2Decoder.stack_frames - frames == 6 * 2 * 20
    assert SelfAttention.score_elements - scores == 12 * 2 * 8 * 20 * 20
    profiling.reset_spans()


def test_serving_spans_nest_and_the_answers_are_tracks(setup):
    """Through `SeldInferencePipeline` (SALSA features on the CPU): the stitch spans
    under `serve.model`, the attention spans under `model.decoder`, all under one
    `serve.request`; the answers are (clips, label frames, 3, n) and (..., 3)."""
    from torch.profiler import ProfilerActivity, profile

    from salsa_tpu_torch.features.registry import make_extractor
    from salsa_tpu_torch.pipeline import SeldInferencePipeline

    model, w, _ = setup
    g = np.random.default_rng(5)
    scaler = (g.normal(-5.0, 1.0, (4, 1, 200)).astype(np.float32),
              g.uniform(5.0, 8.0, (4, 1, 200)).astype(np.float32))
    pipe = SeldInferencePipeline(make_extractor("salsa", "foa"), model, w, scaler, 0.5,
                                 N_CLASSES, "tracks", device="cpu")
    waves = (0.1 * g.standard_normal((2, 4, 24000))).astype(np.float32)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        event, doa = pipe(waves)
    assert event.shape == (2, 10, 3, N_CLASSES) and doa.shape == (2, 10, 3, 3)
    records = profiling.span_records()
    by_id = {r.id: r for r in records}
    parents = {(r.name, by_id[r.parent].name if r.parent else None) for r in records}
    assert {("model.stitch", "serve.model"), ("model.attention", "model.decoder"),
            ("model.decoder", "serve.model")} <= parents
    assert sum(r.name == "model.attention" for r in records) == 12
    assert len({r.root for r in records}) == 1
    profiling.reset_spans()


@pytest.mark.parametrize("metric,name", [("attention_ms.serve", "model.attention"),
                                         ("stitch_ms.serve", "model.stitch")])
def test_span_readers_sum_under_request_roots(monkeypatch, metric, name):
    """Device ms of the spans under `serve.request` roots over the roots; none
    (the parent program, which records no such span) reads None."""
    def rec(n, rid, parent, root, ms):
        return profiling.SpanRecord(n, rid, parent, root, 0, 1, ms)

    records = [rec("serve.request", 1, None, 1, 50.0), rec("model.decoder", 2, 1, 1, 20.0),
               rec(name, 3, 2, 1, 3.0), rec(name, 4, 2, 1, 2.0),
               rec("serve.request", 5, None, 5, 50.0), rec(name, 6, 5, 5, 7.0),
               rec("other", 7, None, 7, 9.0), rec(name, 8, 7, 7, 100.0)]
    read = Manifest(REPO).reader(metric).read
    monkeypatch.setattr(profiling, "span_records", lambda: records)
    assert read(None) == pytest.approx(6.0)
    monkeypatch.setattr(profiling, "span_records", lambda: records[:2])
    assert read(None) is None


def test_operation_count_of_a_request():
    """4 x 60 s FOA (7 x 4801 x 200): 4.40 TFLOP, of which the convolutions 4.01 and
    the attention over 1,200 frames 0.14."""
    parts = einv2_flops(4, 4801, 200)
    assert parts["total"] == pytest.approx(4.3958e12, rel=1e-4)
    assert parts["conv"] == pytest.approx(4.0124e12, rel=1e-4)
    assert parts["attention"] == pytest.approx(12 * 4 * 4 * 1200**2 * 512)


def test_the_reference_and_the_driver_load_nothing_of_jax():
    code = ("import json, sys\n"
            "import seldbench.reference.einv2, seldbench.work_einv2\n"
            "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
            "import seldbench.drivers.serve_tracks\n"
            "print(json.dumps([ref, sorted({m.split('.')[0] for m in sys.modules})]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    reference, driver = json.loads(out.stdout.strip().splitlines()[-1])
    jax = {"jax", "jaxlib", "flax", "optax", "orbax", "salsa_tpu"}
    assert not set(reference) & (jax | {"salsa_tpu_torch"})
    assert not set(driver) & jax


# ----------------------------------------------------------------------------
# the CLIs on the recipe

FS = 8000
TRAIN, VAL = ("tr_a", "tr_b", "tr_c"), ("va_a",)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """2 s clips at 8 kHz with metadata holding same-class overlaps, and the EINV2
    recipe pointed at them: trained by cli.train for 2 steps from wav."""
    from salsa_tpu_torch.cli import train as cli_train
    from salsa_tpu_torch.utils.audio_io import write_wav

    root = str(tmp_path_factory.mktemp("einv2"))
    g = np.random.default_rng(20261019)
    for sub in ("foa_dev", "metadata_dev", "meta"):
        os.makedirs(os.path.join(root, sub))
    for i, name in enumerate(TRAIN + VAL):
        wave = (0.05 * g.standard_normal((4, 2 * FS))).astype(np.float32)
        wave[:, FS // 2:FS] += np.sin(2 * np.pi * 440 * np.arange(FS // 2) / FS) * 0.3
        write_wav(os.path.join(root, "foa_dev", name + ".wav"), wave, FS, bits=16)
        rows = [f"{f},{(f + i) % 3},{k},{(f * 11 + 40 * k) % 360 - 180},{(f * 5) % 60 - 30}"
                for f in range(4, 16) for k in range(2)]  # two events of one class
        with open(os.path.join(root, "metadata_dev", name + ".csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    for split, names in (("train", TRAIN), ("val", VAL), ("test", VAL)):
        with open(os.path.join(root, "meta", f"{split}.csv"), "w") as f:
            f.write("filename\n" + "\n".join(names))
    with open(RECIPE) as f:
        cfg = yaml.safe_load(f)
    cfg.update(feature_root_dir=None, gt_meta_root_dir=root,
               split_meta_dir=os.path.join(root, "meta"))
    cfg["data"].update(fs=FS, n_fft=256, hop_len=100, train_chunk_len_s=0.8,
                       train_chunk_hop_len_s=0.8, test_chunk_len_s=2.0,
                       test_chunk_hop_len_s=2.1, n_classes=3, fmax_doa=3000.0,
                       max_file_len_s=2.0, train_fraction=0.5)
    cfg["training"].update(from_wav=True, train_batch_size=2, max_epochs=1)
    config = os.path.join(root, "einv2.yml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    group = os.path.join(root, "outputs")
    trainer = cli_train.train(config, group, device="cpu")
    return root, config, group, trainer


def test_cli_train_predict_and_infer_on_the_recipe(experiment):
    from salsa_tpu_torch.cli import infer as cli_infer
    from salsa_tpu_torch.cli import predict as cli_predict

    root, config, group, trainer = experiment
    assert trainer.optimizer.count == 2 and np.isfinite(trainer.step_losses).all()
    assert trainer.train_data.sed_targets.shape[1] == 3 * 3  # tracks x classes
    out = cli_predict.predict(config, os.path.join(root, "foa_dev"), os.path.join(root, "pred"),
                              group, device="cpu")
    csvs = sorted(glob.glob(os.path.join(out, "*.csv")))
    assert len(csvs) == len(TRAIN + VAL)
    for path in csvs:
        for rows in load_output_csv(path, "2021").values():
            assert all(0 <= row[-1] < 3 for row in rows)  # a track index a row
    scores = cli_infer.inference(config, group, splits=("val",), device="cpu")
    assert np.isfinite(scores["val"]["seld_error"])
    with pytest.raises(ValueError, match="tracks"):
        cli_infer.inference(config, group, splits=("val",), use_tta=True, device="cpu")
