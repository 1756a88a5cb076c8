"""Export an experiment as a reference-compatible PyTorch checkpoint
(counterpart of `salsa_tpu.cli.export_ckpt`, the inverse of `cli.import_ckpt`):

    python -m salsa_tpu_torch.cli.export_ckpt --exp-config configs/seld.yml \
        --exp-group-dir ./outputs [--exp-suffix _run1] --out /path/to/exported.ckpt \
        [--ckpt <a .msgpack or .orbax>]

Reads the experiment's best checkpoint (else its latest, or `--ckpt`), maps the
flax weights onto the reference's module names (`interop.flax_to_torch_state_dict`)
and writes a Lightning-style `.ckpt` (`{"state_dict": {"model.<key>": tensor}}`)
that `torch.load(..., weights_only=True)` reads and the reference's torch
SeldModel loads strictly. Only PannResNet22 experiments export: PannResNet22TPU
has the same parameter tree but pools before its stem convs, so the reference
encoder would load its weights and compute another function.
"""
from __future__ import annotations

import argparse

from salsa_tpu_torch.cli._errors import cli_entry
from salsa_tpu_torch.interop import flax_to_torch_state_dict, save_torch_checkpoint
from salsa_tpu_torch.train import checkpoint as ckpt
from salsa_tpu_torch.utils.experiments import logger, manage_experiments


def export_checkpoint(exp_config: str, out: str, exp_group_dir: str = "./outputs",
                      exp_suffix: str = "", ckpt_path: str | None = None) -> str:
    """Write the experiment's checkpoint (best, else latest, or `ckpt_path`) as a
    reference `.ckpt` at `out`; returns `out`."""
    cfg = manage_experiments(exp_config, exp_group_dir, exp_suffix, is_train=False)
    if cfg.model.encoder.get("name", "PannResNet22") != "PannResNet22":
        raise ValueError(f"encoder '{cfg.model.encoder.name}' has no reference torch module "
                         "with matching semantics; only PannResNet22 experiments export")
    if ckpt_path is None:
        ckpt_path = (ckpt.best_checkpoint(cfg.dir.model.best)
                     or ckpt.latest_checkpoint(cfg.dir.model.checkpoint))
        if ckpt_path is None:
            raise FileNotFoundError(f"no checkpoint under {cfg.dir.model.best} or "
                                    f"{cfg.dir.model.checkpoint}: train first or pass --ckpt")
    params, stats, _ = ckpt.restore_variables(ckpt_path)
    sd = flax_to_torch_state_dict(params, stats)
    path = save_torch_checkpoint(out, sd, {"exported_from": ckpt_path})
    logger.info("exported %s (%d tensors) -> %s", ckpt_path, len(sd), path)
    return path


@cli_entry
def main(argv: list[str] | None = None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--exp-config", required=True)
    p.add_argument("--out", required=True, help="output .ckpt path")
    p.add_argument("--exp-group-dir", default="./outputs")
    p.add_argument("--exp-suffix", default="")
    p.add_argument("--ckpt", default=None,
                   help="explicit .msgpack or .orbax checkpoint (default: the experiment's best, "
                        "else latest)")
    a = p.parse_args(argv)
    return export_checkpoint(a.exp_config, a.out, a.exp_group_dir, a.exp_suffix,
                             ckpt_path=a.ckpt)


if __name__ == "__main__":
    main()
