"""Experiment directory tree and logging (counterpart of
`salsa_tpu.utils.experiments`): one folder per experiment holding the configs
snapshot, logs, tensorboard, checkpoints (last + best) and outputs (submissions,
predictions). A training run (`is_train=True`) also saves the config it was given
as `configs/config_<stamp>.yml`."""
from __future__ import annotations

import logging
import os
import sys
import time

from salsa_tpu_torch.utils.config import AttrDict, load_config, save_config

logger = logging.getLogger("salsa_tpu_torch")


def manage_experiments(exp_config: str, exp_group_dir: str, exp_suffix: str = "",
                       is_train: bool = False) -> AttrDict:
    """Load `exp_config`, make `salsa_tpu`'s tree under `exp_group_dir` and set
    `cfg.dir` and `cfg.exp_name`, as `salsa_tpu`'s; with is_train, save the config
    (with its `dir` and `exp_name`) into the tree's configs directory."""
    cfg = load_config(exp_config)
    exp_name = os.path.splitext(os.path.basename(exp_config))[0] + exp_suffix
    root = os.path.join(
        exp_group_dir, cfg.mode, cfg.data.audio_format, cfg.feature_type, exp_name
    )
    dirs = AttrDict(
        {
            "exp_dir": root,
            "config_dir": os.path.join(root, "configs"),
            "log_dir": os.path.join(root, "logs"),
            "tb_dir": os.path.join(root, "tensorboard"),
            "model": {
                "checkpoint": os.path.join(root, "models", "checkpoint"),
                "best": os.path.join(root, "models", "best"),
            },
            "output_dir": {
                "submission": os.path.join(root, "outputs", "submissions"),
                "prediction": os.path.join(root, "outputs", "predictions"),
            },
        }
    )
    for d in [dirs.config_dir, dirs.log_dir, dirs.tb_dir, dirs.model.checkpoint,
              dirs.model.best, dirs.output_dir.submission, dirs.output_dir.prediction]:
        os.makedirs(d, exist_ok=True)
    cfg.dir = dirs
    cfg.exp_name = exp_name

    if is_train:
        stamp = time.strftime("%Y%m%d_%H%M%S")
        save_config(cfg, os.path.join(dirs.config_dir, f"config_{stamp}.yml"))

    configure_logging(dirs.log_dir)
    logger.info("Experiment directory: %s", root)
    return cfg


def configure_logging(log_dir: str | None = None, level=logging.INFO) -> logging.Logger:
    """Log to stdout and, with `log_dir`, to `<log_dir>/log.txt`; handlers of an
    earlier call are closed."""
    logger.setLevel(level)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger
