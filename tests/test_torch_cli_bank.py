"""The port's `predict` on the other feature types against salsa_tpu's: the
checkpoint of tests/test_torch_cli.py's reg_xyz experiment served as a
seld_salsa_lite-style experiment (MIC, salsa_lite) and as a melspeciv one
(n_mels 64, fmin 0, fmax 11 kHz) by both packages, batch and --streaming, and
the config's spectral keys recorded where the extractors are built."""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import salsa_tpu.cli.predict as jpredict_mod  # noqa: E402
import salsa_tpu_torch.cli.predict as tpredict_mod  # noqa: E402
from tests.test_torch_cli import (  # noqa: E402,F401
    NEAR,
    SCENES,
    SED_THRESHOLD,
    _csv_rows,
    _write_config,
    workspace,
)
from tests.test_torch_cli_streaming import STREAM_KW, _recording_csvs  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the reg_xyz experiment's checkpoint served as other feature types: the feature
# type's config keys and the scaler's shape (the CRNN's weights do not depend on
# the feature width: the decoder pools the frequency axis)
BANK = {
    "salsa_lite": ({"feature_type": "salsa_lite", "data.audio_format": "mic"}, (4, 1, 191)),
    "melspeciv": ({"feature_type": "melspeciv", "data.n_mels": 64, "data.fmin": 0.0,
                   "data.fmax": 11000.0}, (7, 1, 64)),
}


def _spy(mp, module, name, calls):
    """Record the keyword arguments of every call of `module.name`."""
    target = getattr(module, name)

    def spying(*args, **kwargs):
        calls.append(kwargs)
        return target(*args, **kwargs)

    mp.setattr(module, name, spying)


class _Dropped(Exception):
    pass


@pytest.fixture(scope="module")
def bank_runs(workspace):
    """The other feature types' experiments (BANK) served by both packages'
    `predict`, batch and --streaming (2 streams a dispatch): {ft: {mode: {side:
    (out_dir, {csv: (event_prob, doa)})}}}, with the keyword arguments each side's
    extractors were built with under ("kwargs", mode, side). salsa_tpu's streaming
    path for melspeciv is only built, not run (its extractor's arguments are
    recorded, then the call is stopped): it drops fmin and fmax."""
    import salsa_tpu.streaming as jstreaming

    rng = np.random.default_rng(20261022)
    src = workspace / "outputs" / "crossval" / "foa" / "salsa" / "exp" / "models" / "best"
    out = {}
    for ft, (extra, shape) in BANK.items():
        config = _write_config(workspace, f"bank_{ft}", "reg_xyz", **extra)
        models = (workspace / "outputs" / "crossval" / ("mic" if ft == "salsa_lite" else "foa")
                  / ft / "exp" / "models")
        shutil.copytree(src, models / "best")
        np.savez(str(models / "feature_scaler.npz"),
                 mean=rng.normal(-5.0, 1.0, shape).astype(np.float32),
                 std=rng.uniform(5.0, 8.0, shape).astype(np.float32))
        out[ft] = {}
        for mode, kw_mode in (("batch", {}), ("streaming", dict(streaming=True, streams=2,
                                                                **STREAM_KW))):
            out[ft][mode] = {}
            for side, module, kw in (("jax", jpredict_mod, {}),
                                     ("port", tpredict_mod, {"device": "cpu"})):
                calls = []
                with pytest.MonkeyPatch.context() as mp:
                    arrays = _recording_csvs(module, mp)
                    if side == "port":
                        _spy(mp, module, "StreamingExtractor" if kw_mode else "make_extractor",
                             calls)
                    elif kw_mode:
                        def stop(*args, **kwargs):
                            calls.append(kwargs)
                            if ft == "melspeciv":
                                raise _Dropped
                            return jstreaming_extractor(*args, **kwargs)

                        jstreaming_extractor = jstreaming.StreamingExtractor
                        mp.setattr(jstreaming, "StreamingExtractor", stop)
                    try:
                        out_dir = module.predict(config, str(workspace / "wavs"),
                                                 str(workspace / f"bank_{ft}_{mode}_{side}"),
                                                 exp_group_dir=str(workspace / "outputs"),
                                                 **kw_mode, **kw)
                    except _Dropped:
                        out_dir = None
                out[ft][mode][side] = (out_dir, arrays)
                out[ft][("kwargs", mode, side)] = calls
    return out


@pytest.mark.parametrize("ft,mode", [("salsa_lite", "batch"), ("salsa_lite", "streaming"),
                                     ("melspeciv", "batch")])
def test_other_feature_types_predict_as_salsa_tpu(bank_runs, ft, mode):
    """A seld_salsa_lite-style experiment (MIC, salsa_lite) and a melspeciv one
    served by both packages' `predict`, batch and --streaming: the frame-local
    features differ only by rounding, so the arrays agree within
    test_seldnet_matches_flax's tolerance and the CSVs carry the same rows (a row
    in one only where its probability lies within NEAR of the threshold)."""
    (j_dir, j_arrays), (t_dir, t_arrays) = bank_runs[ft][mode]["jax"], bank_runs[ft][mode]["port"]
    names = sorted(os.listdir(j_dir))
    assert names == sorted(os.listdir(t_dir)) == sorted(t_arrays) == sorted(
        f"{n}.csv" for n, _, _ in SCENES)
    compared = 0
    for name in names:
        (ev_j, doa_j), (ev_t, doa_t) = j_arrays[name], t_arrays[name]
        assert ev_t.shape == ev_j.shape and ev_j.std() > 0.01
        np.testing.assert_allclose(ev_t, ev_j, atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(doa_t, doa_j, atol=5e-4, rtol=1e-3)
        got, want = _csv_rows(os.path.join(t_dir, name)), _csv_rows(os.path.join(j_dir, name))
        for key in set(got) ^ set(want):
            assert abs(ev_j[key] - SED_THRESHOLD["reg_xyz"]) <= NEAR, (name, key)
        for key in set(got) & set(want):
            (ga, ge), (wa, we) = got[key], want[key]
            assert min(abs(ga - wa), 360 - abs(ga - wa)) <= 1 and abs(ge - we) <= 1
            compared += 1
    assert compared >= 20, compared


def test_predict_passes_the_spectral_keys(bank_runs):
    """n_mels, fmin and fmax of the config reach the port's extractor on the batch
    and the streaming paths alike (n_mels 64: the 64-bin scaler normalizes the
    features, which would raise at 128 bins). salsa_tpu's streaming path
    (salsa_tpu/cli/predict.py:180-184, and :272 for the pool) passes n_mels and
    fmax_doa only, so it streams other features than a config's fmin and fmax
    give (ROADMAP queue 3)."""
    want = {"n_mels": 64, "fmin": 0.0, "fmax": 11000.0}
    for mode in ("batch", "streaming"):
        (kwargs,) = bank_runs["melspeciv"][("kwargs", mode, "port")]
        assert {k: kwargs[k] for k in want} == want, (mode, kwargs)
        assert len(bank_runs["melspeciv"][mode]["port"][1]) == len(SCENES)
    (j_kwargs,) = bank_runs["melspeciv"][("kwargs", "streaming", "jax")]
    assert j_kwargs["n_mels"] == 64 and "fmin" not in j_kwargs and "fmax" not in j_kwargs
    (lite,) = bank_runs["salsa_lite"][("kwargs", "streaming", "port")]
    assert lite["fmin_doa"] == 50 and lite["fmax_doa"] is None


def test_predict_passes_the_eig_method(workspace):
    """A model trained on `training.eig_method: eigh` features is served on eigh
    features, batch and --streaming: the key reaches the port's extractors as
    cli.train passes it to the scaler fit, the val split and every step.
    salsa_tpu's batch path (salsa_tpu/cli/predict.py:74-80) drops it and serves
    K1's features (ROADMAP queue 3)."""
    config = _write_config(workspace, "eigh", "reg_xyz", **{"training.eig_method": "eigh"})
    for mode, kw_mode, name in (("batch", {}, "make_extractor"),
                                ("streaming", dict(streaming=True, streams=2, **STREAM_KW),
                                 "StreamingExtractor")):
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            arrays = _recording_csvs(tpredict_mod, mp)
            _spy(mp, tpredict_mod, name, calls)
            tpredict_mod.predict(config, str(workspace / "wavs"),
                                 str(workspace / f"eigh_{mode}"),
                                 exp_group_dir=str(workspace / "outputs"), device="cpu", **kw_mode)
        ((kwargs,),) = (calls,)
        assert kwargs["eig_method"] == "eigh", (mode, kwargs)
        assert len(arrays) == len(SCENES) and all(
            np.isfinite(ev).all() and np.isfinite(doa).all() for ev, doa in arrays.values())

    def stop(*args, **kwargs):
        j_calls.append(kwargs)
        raise _Dropped

    j_calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpredict_mod, "make_extractor", stop)
        with pytest.raises(_Dropped):
            jpredict_mod.predict(config, str(workspace / "wavs"), str(workspace / "eigh_jax"),
                                 exp_group_dir=str(workspace / "outputs"))
    assert "eig_method" not in j_calls[0]
