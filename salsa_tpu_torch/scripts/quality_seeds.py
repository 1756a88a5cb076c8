"""Error bars for the quality study: `quality_evidence` over several data seeds, the
port's counterpart of `scripts/quality_seeds.py`.

    python -m salsa_tpu_torch.scripts.quality_seeds --seeds 11 12 13 [--clips 48 --epochs 48]
        [--members 3] [--workdir DIR] [--cpu]

Each seed runs `salsa_tpu_torch.scripts.quality_evidence` on an independent
synthetic corpus of the same budget (its `--data-seed`), in this process on the
card, and its result is kept as `<workdir>/s<seed>_result.json`, so that a rerun
skips the seeds already done. Then, as the original, the mean and sample sd of
each row's SELD error over the seeds (plain, TTA, the fused ensemble and its
best member, SWA on the plain schedule, the constant-tail member and its SWA),
and the paired gains (TTA - plain, ensemble - best member, SWA tail - its
member; negative is better). `--cpu` runs the study on the CPU (a check of the
script). Prints one JSON object, `{"quality_seeds": {"seeds", "table"}}`.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from salsa_tpu_torch.scripts import quality_evidence


def run_seed(seed: int, clips: int, epochs: int, members: int, workdir: str,
             device: str) -> dict:
    """`quality_evidence` on the corpus of data seed `seed`, or its kept result."""
    result_path = os.path.join(workdir, f"s{seed}_result.json")
    if os.path.isfile(result_path):
        with open(result_path) as f:
            return json.load(f)
    result = quality_evidence.main(
        ["--clips", str(clips), "--epochs", str(epochs), "--members", str(members),
         "--data-seed", str(seed), "--workdir", os.path.join(workdir, f"s{seed}")],
        device=device)
    with open(result_path, "w") as f:
        json.dump(result, f)
    return result


def _seld(row) -> float:
    return float(row["seld_error"])


VARIANTS = {
    "plain": lambda r: _seld(r["tta"]["no_tta"]),
    "tta": lambda r: _seld(r["tta"]["tta"]),
    "ensemble": lambda r: float(r["ensemble"]["fused"]),
    "ensemble_best_member": lambda r: float(r["ensemble"]["best_member"]),
    "swa_plain_schedule": lambda r: _seld(r["swa"]["swa"]),
    "swa_tail_member": lambda r: _seld(r["swa_tail"]["member_const_tail"]),
    "swa_tail": lambda r: _seld(r["swa_tail"]["swa"]),
}
GAINS = {"tta_gain": ("tta", "plain"), "ensemble_gain": ("ensemble", "ensemble_best_member"),
         "swa_tail_gain": ("swa_tail", "swa_tail_member")}


def summarize(values) -> dict:
    a = np.asarray(values, np.float64)
    return {"mean": round(float(a.mean()), 4),
            "sd": round(float(a.std(ddof=1)) if len(a) > 1 else 0.0, 4),
            "n": len(a), "values": [round(float(v), 4) for v in a]}


def table(per_seed: dict) -> dict:
    """Each variant's mean and sd over the seeds, then the paired gains."""
    out = {}
    for name, get in VARIANTS.items():
        vals = []
        for r in per_seed.values():
            try:
                vals.append(get(r))
            except (KeyError, IndexError, TypeError):
                pass
        if vals:
            out[name] = summarize(vals)
    for gain, (a, b) in GAINS.items():
        if a in out and b in out and out[a]["n"] == out[b]["n"]:
            out[gain] = summarize(np.asarray(out[a]["values"]) - np.asarray(out[b]["values"]))
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 12, 13])
    ap.add_argument("--clips", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=48)
    ap.add_argument("--members", type=int, default=3)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "salsa_tpu_torch_quality_seeds"))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (a check)")
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    per_seed = {}
    for seed in args.seeds:
        per_seed[seed] = run_seed(seed, args.clips, args.epochs, args.members, args.workdir,
                                  "cpu" if args.cpu else "cuda")
        print(json.dumps({"seed_done": seed}), flush=True)
    out = {"seeds": args.seeds, "table": table(per_seed)}
    print(json.dumps({"quality_seeds": out}, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
