"""Import a trained reference (PyTorch / Lightning) checkpoint into an experiment
(counterpart of `salsa_tpu.cli.import_ckpt`):

    python -m salsa_tpu_torch.cli.import_ckpt --exp-config configs/seld.yml \
        --torch-ckpt /path/to/reference_epoch=41.ckpt \
        --exp-group-dir ./outputs [--exp-suffix _imported] [--trust-checkpoint]

Writes `models/best/best.msgpack` (and its `.json` sidecar) into the experiment
tree in flax's msgpack format, with a fresh optimizer state (count 0), as
`salsa_tpu`'s import does; `cli.predict` and `cli.infer` of either package then
serve the reference's weights. The port's modules carry the reference's names,
so the import is a strict key and shape check against the config's model
(`interop.load_reference_state_dict`); a checkpoint that does not map raises,
naming the missing and unexpected keys.
"""
from __future__ import annotations

import argparse

from salsa_tpu_torch.cli._errors import cli_entry
from salsa_tpu_torch.interop import (
    load_reference_state_dict,
    load_torch_state_dict,
    torch_state_dict_to_flax,
)
from salsa_tpu_torch.models.seld import build_model
from salsa_tpu_torch.train.checkpoint import save_checkpoint
from salsa_tpu_torch.train.state import make_optimizer
from salsa_tpu_torch.utils.experiments import logger, manage_experiments


def import_checkpoint(exp_config: str, torch_ckpt: str, exp_group_dir: str = "./outputs",
                      exp_suffix: str = "", trust_checkpoint: bool = False) -> str:
    """Write the reference checkpoint `torch_ckpt` as the experiment's best
    checkpoint; returns its path."""
    cfg = manage_experiments(exp_config, exp_group_dir, exp_suffix, is_train=True)
    model = build_model(encoder=cfg.model.encoder.to_dict(), decoder=cfg.model.decoder.to_dict(),
                        n_classes=cfg.data.n_classes,
                        output_format=cfg.data.get("output_format", "reg_xyz"))
    load_reference_state_dict(model, load_torch_state_dict(torch_ckpt,
                                                           trust_checkpoint=trust_checkpoint))
    params, stats = torch_state_dict_to_flax(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    fresh = make_optimizer(model.parameters(), 1)
    path = save_checkpoint(cfg.dir.model.best, "best", params, stats, 0,
                           {"imported_from": torch_ckpt, "n_params": n_params},
                           opt_state=fresh.optax_state(model))
    logger.info("imported %s (%.2fM params) -> %s", torch_ckpt, n_params / 1e6, path)
    return path


@cli_entry
def main(argv: list[str] | None = None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--exp-config", required=True)
    p.add_argument("--torch-ckpt", required=True)
    p.add_argument("--exp-group-dir", default="./outputs")
    p.add_argument("--exp-suffix", default="")
    p.add_argument("--trust-checkpoint", action="store_true",
                   help="allow full (unsafe) unpickling for checkpoints that "
                        "torch.load(weights_only=True) cannot read")
    a = p.parse_args(argv)
    return import_checkpoint(a.exp_config, a.torch_ckpt, a.exp_group_dir, a.exp_suffix,
                             trust_checkpoint=a.trust_checkpoint)


if __name__ == "__main__":
    main()
