"""Both packages' `predict --streaming` (2 streams a dispatch) and `--streaming
--pool` (2 slots) on tests/test_torch_cli.py's reg_xyz experiment, compared as
that file compares the batch path's; and the two `salsa_tpu` streaming faults
the port does not copy (a truncated wav in a group, a --max-lag-ms below one
packet)."""
import os

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

STREAM_KW = dict(block_frames=32, context_frames=32, push_ms=100.0)


def _recording_csvs(module, mp):
    """Record every (CSV name, event_prob, doa) `module` writes."""
    rows, write = {}, module.write_classwise_csv

    def recording(path, ev, doa, *args, **kwargs):
        rows[os.path.basename(path)] = (ev, doa)
        return write(path, ev, doa, *args, **kwargs)

    mp.setattr(module, "write_classwise_csv", recording)
    return rows


@pytest.fixture(scope="module")
def stream_runs(workspace):
    """Both packages' `predict --streaming` (2 streams a dispatch) and `--streaming
    --pool` (2 slots) at blocks of 32 frames, context 32, on the reg_xyz
    experiment: {mode: {side: (out_dir, {csv: (event_prob, doa)})}}."""
    config = _write_config(workspace, "reg_xyz")
    out = {}
    for mode, extra in (("streaming", {}), ("pool", {"pool": True})):
        out[mode] = {}
        for side, module, kw in (("jax", jpredict_mod, {}), ("port", tpredict_mod,
                                                             {"device": "cpu"})):
            with pytest.MonkeyPatch.context() as mp:
                arrays = _recording_csvs(module, mp)
                out_dir = module.predict(config, str(workspace / "wavs"),
                                         str(workspace / f"stream_{mode}_{side}"),
                                         exp_group_dir=str(workspace / "outputs"),
                                         streaming=True, streams=2, **STREAM_KW, **extra, **kw)
            out[mode][side] = (out_dir, arrays)
    return out


@pytest.mark.parametrize("mode", ["streaming", "pool"])
def test_streaming_predict_matches_salsa_tpu(stream_runs, mode):
    """The CSVs of both packages' streaming CLIs, compared as
    test_predict_matches_salsa_tpu compares the batch path's (salsa_tpu on its XLA
    power iteration, the port on K1's arithmetic); the pool's arrays equal the
    lockstep path's within the batch == solo bound."""
    (j_dir, j_arrays), (t_dir, t_arrays) = stream_runs[mode]["jax"], stream_runs[mode]["port"]
    names = sorted(os.listdir(j_dir))
    assert names == sorted(os.listdir(t_dir)) == sorted(f"{n}.csv" for n, _, _ in SCENES)
    assert sorted(t_arrays) == names
    compared = 0
    for name in names:
        (ev_j, doa_j), (ev_t, doa_t) = j_arrays[name], t_arrays[name]
        assert ev_t.shape == ev_j.shape and ev_j.std() > 0.01
        for got, want in ((ev_t, ev_j), (doa_t, doa_j)):
            err = np.abs(got - want)
            assert np.mean(err <= 2e-3) >= 0.999 and err.max() <= 2e-2, err.max()
        got, want = _csv_rows(os.path.join(t_dir, name)), _csv_rows(os.path.join(j_dir, name))
        for key in set(got) ^ set(want):
            assert abs(ev_j[key] - SED_THRESHOLD["reg_xyz"]) <= NEAR, (name, key)
        for key in set(got) & set(want):
            (ga, ge), (wa, we) = got[key], want[key]
            assert min(abs(ga - wa), 360 - abs(ga - wa)) <= 1 and abs(ge - we) <= 1
            compared += 1
        if mode == "pool":
            ev_s, doa_s = stream_runs["streaming"]["port"][1][name]
            np.testing.assert_allclose(ev_t, ev_s, atol=1e-5, rtol=0)
            np.testing.assert_allclose(doa_t, doa_s, atol=1e-5, rtol=0)
    assert compared >= 50, compared


def _exp_log(workspace):
    return (workspace / "outputs" / "crossval" / "foa" / "salsa" / "exp" / "logs" /
            "log.txt").read_text()


def test_streaming_serves_a_truncated_wav_in_a_group(workspace, tmp_path):
    """salsa_tpu/cli/predict.py:195 groups clips by their header's length; a wav
    whose data is cut short then fails to fit its group with --streams 2. The port
    checks the decoded length and serves the clip alone at it."""
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for name in ("clip_a", "clip_b"):
        (wavs / f"{name}.wav").write_bytes((workspace / "wavs" / f"{name}.wav").read_bytes())
    data = (wavs / "clip_b.wav").read_bytes()
    (wavs / "clip_b.wav").write_bytes(data[:len(data) - 4 * 2 * 2400])  # 0.1 s short
    config = _write_config(workspace, "reg_xyz")
    group = str(workspace / "outputs")
    with pytest.raises(ValueError, match="could not broadcast"):
        jpredict_mod.predict(config, str(wavs), str(tmp_path / "jax"), group, streaming=True,
                             streams=2, **STREAM_KW)
    with pytest.MonkeyPatch.context() as mp:
        arrays = _recording_csvs(tpredict_mod, mp)
        tpredict_mod.predict(config, str(wavs), str(tmp_path / "port"), group, device="cpu",
                             streaming=True, streams=2, **STREAM_KW)
    assert "clip_b.wav: 36000 samples decoded where its header declares 38400" in \
        _exp_log(workspace)
    with pytest.MonkeyPatch.context() as mp:
        solo = _recording_csvs(tpredict_mod, mp)
        tpredict_mod.predict(config, str(wavs), str(tmp_path / "solo"), group, device="cpu",
                             streaming=True, **STREAM_KW)
    for name in ("clip_a.csv", "clip_b.csv"):
        for got, want in zip(arrays[name], solo[name]):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert arrays["clip_b.csv"][0].shape[0] < arrays["clip_a.csv"][0].shape[0]


def test_pool_raises_max_lag_below_one_packet(workspace, tmp_path, stream_runs):
    """salsa_tpu/cli/predict.py:281 hands the pool a --max-lag-ms below one push
    packet, so each healthy stream's next packet reads as lag and is zero-filled
    (the log warns; the CSVs carry concealment output). The port raises max_lag to
    one packet: no fill, and the exact pool's arrays."""
    config = _write_config(workspace, "reg_xyz")
    kw = dict(exp_group_dir=str(workspace / "outputs"), streaming=True, pool=True, streams=2,
              max_lag_ms=10.0, **STREAM_KW)
    jpredict_mod.predict(config, str(workspace / "wavs"), str(tmp_path / "jax"), **kw)
    assert "stall policy zero-filled" in _exp_log(workspace)
    with pytest.MonkeyPatch.context() as mp:
        arrays = _recording_csvs(tpredict_mod, mp)
        tpredict_mod.predict(config, str(workspace / "wavs"), str(tmp_path / "port"),
                             device="cpu", **kw)
    text = _exp_log(workspace)
    assert "--max-lag-ms 10 is below one push packet (100 ms, 2400 samples)" in text
    assert "zero-filled" not in text.split("--max-lag-ms 10 is below")[-1]
    for name, (ev, doa) in arrays.items():
        ev_p, doa_p = stream_runs["pool"]["port"][1][name]
        np.testing.assert_array_equal(ev, ev_p)
        np.testing.assert_array_equal(doa, doa_p)

