"""Measured quality evidence for TTA, ensemble fusion, SWA and the threshold sweep,
on the CUDA card (the port's copy of `scripts/quality_evidence.py`).

On the synthetic corpus of `salsa_tpu_torch.scripts.synthetic_sanity`:

  1. write the FOA corpus (`--clips`, data seed `--data-seed`; the last
     max(2, clips // 6) clips validate);
  2. train `--members` members (identical config, seeds 100, 101, ...) from the
     raw wavs with `cli.train`;
  3. infer each member's val split with `cli.infer`, plain and with `--tta`
     (16 FOA variants), keeping both dumps;
  4. fuse the members' plain dumps, and their TTA'd dumps (output-space
     ensembles), with `cli.ensemble` and score them;
  5. average member 0's last `--swa-tail` epoch checkpoints (SWA) and score the
     average; then train one more member whose last 30 % of epochs run at a
     constant lr and average checkpoints from inside that phase;
  6. sweep sed_threshold over member 0's plain dumps, the plain fusion and the
     TTA'd fusion (host only): fusing probabilities flattens the SED peaks, so
     each mode has its own operating point.

Prints one JSON line per measurement, as the original does, and a last
`{"quality_evidence": {...}}` line. The model is the original's, bf16
PannResNet22TPU; where the original trains on a feature store, the study trains
from the wavs, features extracted on the card inside every step (the port can
train from a store too: `cli.extract`, then the config's `feature_root_dir`; the
study keeps one corpus and no store per seed). Each epoch's checkpoint of the
full-width CRNN is ~135 MB, so the epoch checkpoints a later stage does not read
are deleted as soon as a member is trained (each member's best stays).

    python -m salsa_tpu_torch.scripts.quality_evidence [--clips 48 --epochs 48]
    python -m salsa_tpu_torch.scripts.quality_evidence --sweep-only   # re-score the dumps
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

from salsa_tpu_torch.scripts.synthetic_sanity import N_CLASSES, experiment_config, write_corpus
from salsa_tpu_torch.utils.config import save_config

SWEEP_THRESHOLDS = tuple(round(0.05 * k, 2) for k in range(2, 13))  # 0.10 .. 0.60


def _exp_dir(root: str, suffix: str) -> str:
    return os.path.join(root, "outputs", "crossval", "foa", "salsa", f"exp{suffix}")


def _write_exp(root: str, data_dir: str, meta_dir: str, seed: int, epochs: int,
               tail_const: bool = False) -> str:
    """<root>/exp.yml: the synthetic corpus's experiment (every member shares the
    name exp; the suffix tells them apart). With tail_const, the last 30 % of
    training runs at a constant lr, SWA's averaging phase."""
    cfg = experiment_config(data_dir, meta_dir, "salsa", "foa", seed, epochs,
                            encoder="PannResNet22TPU")
    if tail_const:
        cfg["training"]["lr_scheduler"] = {"milestones": [0.0, 0.1, 0.55, 0.7, 1.0],
                                           "lrs": [3e-4, 3e-4, 3e-4, 1e-4, 1e-4],
                                           "moms": [0.9, 0.9, 0.9, 0.9, 0.9]}
    path = os.path.join(root, "exp.yml")
    save_config(cfg, path)
    return path


def _keep_tail(exp_dir: str, n_keep: int) -> list[str]:
    """Delete all but the last n_keep epoch checkpoints of an experiment; returns
    the kept .msgpack paths in epoch order."""
    ckpt_dir = os.path.join(exp_dir, "models", "checkpoint")
    names = sorted(f[:-len(".msgpack")] for f in os.listdir(ckpt_dir) if f.endswith(".msgpack"))
    drop, keep = names[:len(names) - n_keep], names[len(names) - n_keep:]
    for name in drop:
        for ext in (".msgpack", ".json"):
            path = os.path.join(ckpt_dir, name + ext)
            if os.path.isfile(path):
                os.remove(path)
    return [os.path.join(ckpt_dir, n + ".msgpack") for n in keep]


def _swa_experiment(root: str, member_dir: str, suffix: str, tail: list[str]) -> str:
    """An experiment `exp<suffix>` whose only checkpoint is the average of `tail`,
    with the member's scaler; returns its directory."""
    from salsa_tpu_torch.train.ensemble import average_checkpoint_files

    swa_dir = _exp_dir(root, suffix)
    shutil.rmtree(swa_dir, ignore_errors=True)
    os.makedirs(os.path.join(swa_dir, "models", "checkpoint"))
    shutil.copyfile(os.path.join(member_dir, "models", "feature_scaler.npz"),
                    os.path.join(swa_dir, "models", "feature_scaler.npz"))
    average_checkpoint_files(tail, os.path.join(swa_dir, "models", "checkpoint",
                                                "epoch000.msgpack"))
    return swa_dir


def _trained(exp_dir: str) -> bool:
    best = os.path.join(exp_dir, "models", "best")
    return os.path.isdir(best) and any(f.endswith(".msgpack") for f in os.listdir(best))


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=48)
    ap.add_argument("--members", type=int, default=3)
    ap.add_argument("--swa-tail", type=int, default=8)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "salsa_tpu_torch_quality"))
    ap.add_argument("--data-seed", type=int, default=11)
    ap.add_argument("--sweep-only", action="store_true",
                    help="skip training and inference and re-run only the sed_threshold "
                         "sweep over the dumps a previous run left in --workdir")
    args = ap.parse_args(argv)
    root = args.workdir
    if args.sweep_only:
        return {"threshold_sweep": run_threshold_sweep(root, args.members)}

    import torch

    from salsa_tpu_torch.cli.ensemble import ensemble
    from salsa_tpu_torch.cli.infer import inference
    from salsa_tpu_torch.cli.train import train

    t0 = time.time()
    data_dir, meta_dir = write_corpus(root, args.clips, args.data_seed, "foa")
    print(f"generated {args.clips} clips in {time.time() - t0:.1f}s", flush=True)
    gt_meta = os.path.join(data_dir, "metadata_dev")
    group = os.path.join(root, "outputs")

    def infer(exp_path, suffix, keep_as=None, **kw):
        """cli.infer of val, timed on the host clock; the dumps copied to keep_as."""
        if device != "cpu":
            torch.cuda.synchronize()
        t = time.time()
        r = inference(exp_path, group, suffix, splits=["val"], device=device, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        dt = round(time.time() - t, 2)
        if keep_as:
            shutil.rmtree(keep_as, ignore_errors=True)
            shutil.copytree(os.path.join(_exp_dir(root, suffix), "outputs", "predictions",
                                         "val"), keep_as)
        return r["val"], dt

    results: dict = {}
    member_scores, plain_dirs, tta_dirs = [], [], []
    for m in range(args.members):
        seed, suffix = 100 + m, f"_m{m}"
        exp_path = _write_exp(root, data_dir, meta_dir, seed, args.epochs)
        exp_dir = _exp_dir(root, suffix)
        if not _trained(exp_dir):
            t = time.time()
            train(exp_path, group, suffix, device=device)
            print(f"member {m} (seed {seed}) trained in {time.time() - t:.0f}s", flush=True)
            _keep_tail(exp_dir, args.swa_tail if m == 0 else 0)
        plain_dirs.append(os.path.join(root, f"plain_dumps_m{m}"))
        tta_dirs.append(os.path.join(root, f"tta_dumps_m{m}"))
        plain, dt_plain = infer(exp_path, suffix, plain_dirs[-1])
        tta, dt_tta = infer(exp_path, suffix, tta_dirs[-1], use_tta=True)
        member_scores.append(plain)
        print(json.dumps({"member": m, "seed": seed, "val": plain, "infer_s": dt_plain}),
              flush=True)
        if m == 0:
            results["tta"] = {"no_tta": plain, "tta": tta, "infer_s": dt_plain,
                              "tta_infer_s": dt_tta}
            print(json.dumps({"tta_row": results["tta"]}), flush=True)
        if device != "cpu":
            torch.cuda.empty_cache()

    # output-space ensembles of the members, plain and TTA'd (the reference's
    # 2nd-place recipe: per-member TTA, then fusion)
    ens = ensemble(plain_dirs, os.path.join(root, "fused"), n_classes=N_CLASSES,
                   gt_meta_dir=gt_meta)
    results["ensemble"] = {"members": [s["seld_error"] for s in member_scores],
                           "best_member": min(s["seld_error"] for s in member_scores),
                           "fused": ens["seld_error"], "scores": ens}
    print(json.dumps({"ensemble_row": results["ensemble"]}), flush=True)
    ens_tta = ensemble(tta_dirs, os.path.join(root, "fused_tta"), n_classes=N_CLASSES,
                       gt_meta_dir=gt_meta)
    results["ensemble_tta"] = {"fused_plain": ens["seld_error"],
                               "fused_tta": ens_tta["seld_error"], "scores": ens_tta}
    print(json.dumps({"ensemble_tta_row": results["ensemble_tta"]}), flush=True)

    # SWA over member 0's tail checkpoints
    m0_dir = _exp_dir(root, "_m0")
    tail = _keep_tail(m0_dir, args.swa_tail)
    _swa_experiment(root, m0_dir, "_swa", tail)
    swa, _ = infer(_write_exp(root, data_dir, meta_dir, 100, args.epochs), "_swa",
                   checkpoint_kind="last")
    results["swa"] = {"n_ckpts": len(tail), "member0": member_scores[0], "swa": swa}
    print(json.dumps({"swa_row": results["swa"]}), flush=True)

    # SWA with its averaging phase: a member whose last 30 % of epochs run at a
    # constant lr, averaged over checkpoints from inside that phase, against the
    # same member's own best checkpoint
    swam_path = _write_exp(root, data_dir, meta_dir, 100, args.epochs, tail_const=True)
    swam_dir = _exp_dir(root, "_swam")
    n_const = max(2, int(0.3 * args.epochs) - 2)  # inside the constant phase
    if not _trained(swam_dir):
        t = time.time()
        train(swam_path, group, "_swam", device=device)
        print(f"tail-const member trained in {time.time() - t:.0f}s", flush=True)
    tail = _keep_tail(swam_dir, n_const)
    member_const, _ = infer(swam_path, "_swam")
    _swa_experiment(root, swam_dir, "_swa2", tail)
    swa2, _ = infer(swam_path, "_swa2", checkpoint_kind="last")
    results["swa_tail"] = {"n_ckpts": len(tail), "member_const_tail": member_const,
                           "swa": swa2}
    print(json.dumps({"swa_tail_row": results["swa_tail"]}), flush=True)

    results["threshold_sweep"] = run_threshold_sweep(root, args.members)
    print(json.dumps({"quality_evidence": results}), flush=True)
    return results


def run_threshold_sweep(root: str, n_members: int) -> dict:
    """Score member 0's plain dumps, the plain fusion and the TTA'd fusion across
    sed_threshold (host only), from the dumps under `root`."""
    from salsa_tpu_torch.train.threshold import sweep_pred_dirs

    gt_meta = os.path.join(root, "task3", "metadata_dev")
    plain = [os.path.join(root, f"plain_dumps_m{m}") for m in range(n_members)]
    tta = [os.path.join(root, f"tta_dumps_m{m}") for m in range(n_members)]
    modes = {"member0_plain": plain[:1], "fused_plain": plain, "fused_tta": tta}
    sweep: dict = {}
    for name, dirs in modes.items():
        missing = [d for d in dirs if not os.path.isdir(d)]
        if missing:
            raise FileNotFoundError(f"{name}: missing prediction dumps {missing} — run the "
                                    "full study first (without --sweep-only)")
        s = sweep_pred_dirs(dirs, gt_meta, N_CLASSES, thresholds=SWEEP_THRESHOLDS)
        at_default = next(r for r in s["rows"] if abs(r["threshold"] - 0.3) < 1e-9)
        sweep[name] = {"best": s["best"], "at_0.30": at_default, "rows": s["rows"]}
        print(json.dumps({"sweep_row": {name: s["best"]}}), flush=True)
    print(json.dumps({"threshold_sweep": {n: {"best": v["best"], "at_0.30": v["at_0.30"]}
                                          for n, v in sweep.items()}}), flush=True)
    return sweep


if __name__ == "__main__":
    main()
