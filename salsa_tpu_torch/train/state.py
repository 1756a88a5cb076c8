"""The optimizer (counterpart of `salsa_tpu.train.state.make_optimizer`): torch's
Adam or AdamW with the learning rate and beta1 scheduled as
`optax.inject_hyperparams` schedules them.

Before each update the group's `lr` and `betas[0]` are set from the schedules at
the optimizer's step count before that update (0 for the first), which is the
count inject_hyperparams evaluates them at; Adam's bias correction 1 - b1^t then
takes the current b1, as optax's does. `optax_state` writes the state in optax's
layout (count, hyperparams, mu and nu as flax parameter trees) for checkpoints
that `salsa_tpu` restores; `load_optax_state` reads that layout back, from the
port's checkpoints and from `salsa_tpu`'s.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from salsa_tpu_torch.interop import flax_to_torch_state_dict, torch_state_dict_to_flax
from salsa_tpu_torch.train.schedules import make_lr_momentum_schedules

B2, EPS = 0.999, 1e-8  # optax.adam's defaults, which salsa_tpu keeps


class ScheduledOptimizer:
    """Adam (or AdamW, weight decay 0.01) over `params` with the scheduled lr and
    beta1. `lr` and `b1` hold the values of the last update (of step 0 before the
    first), as optax's `opt_state.hyperparams` does."""

    def __init__(self, params, total_steps: int, optimizer_name: str = "adam",
                 milestones=(0.0, 0.1, 0.7, 1.0), lrs=(3e-4, 3e-4, 3e-4, 1e-4),
                 moms=(0.9, 0.9, 0.9, 0.9), weight_decay: float = 0.01):
        self.lr_schedule, self.mom_schedule = make_lr_momentum_schedules(
            total_steps, milestones, lrs, moms)
        self.name = optimizer_name.lower()
        self.lr, self.b1 = self.lr_schedule(0), self.mom_schedule(0)
        kw = dict(lr=float(self.lr), betas=(float(self.b1), B2), eps=EPS)
        if self.name == "adam":
            self.optimizer = torch.optim.Adam(params, **kw)
        elif self.name == "adamw":
            self.weight_decay = weight_decay
            self.optimizer = torch.optim.AdamW(params, weight_decay=weight_decay, **kw)
        else:
            raise ValueError(f"unknown optimizer '{optimizer_name}'")
        self.count = 0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update with lr and beta1 at the current count."""
        self.lr, self.b1 = self.lr_schedule(self.count), self.mom_schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = float(self.lr)
            group["betas"] = (float(self.b1), B2)
        self.optimizer.step()
        self.count += 1

    def optax_state(self, model: nn.Module) -> dict:
        """This optimizer's state as `optax.inject_hyperparams(optax.adam[w])`'s, a
        tree of numpy arrays: Adam's first and second moments laid out as the flax
        parameter tree of `model` (through `interop`), zeros before the first
        update."""
        names = {id(p): n for n, p in model.named_parameters()}
        sd = {k: v.detach() for k, v in model.state_dict().items()}
        moments = []
        for key in ("exp_avg", "exp_avg_sq"):
            tree = dict(sd)
            for group in self.optimizer.param_groups:
                for p in group["params"]:
                    st = self.optimizer.state.get(p, {})
                    tree[names[id(p)]] = st[key] if key in st else torch.zeros_like(p)
            moments.append(torch_state_dict_to_flax(
                tree, torch_tree=not model.flax_counterpart)[0])
        count = np.asarray(self.count, np.int32)
        hyper = {"b1": np.float32(self.b1), "b2": np.float32(B2), "eps": np.float32(EPS),
                 "eps_root": np.float32(0.0), "learning_rate": np.float32(self.lr)}
        inner = {"0": {"count": count, "mu": moments[0], "nu": moments[1]}, "1": {}}
        if self.name == "adamw":
            hyper["weight_decay"] = np.float32(self.weight_decay)
            inner["2"] = {}
        return {"count": count,
                "hyperparams": {k: np.asarray(v) for k, v in hyper.items()},
                "hyperparams_states": {"b1": {"count": count},
                                       "learning_rate": {"count": count}},
                "inner_state": inner}

    def load_optax_state(self, model: nn.Module, opt_state: dict) -> None:
        """Set this optimizer from a tree in `optax_state`'s layout (a restored
        checkpoint's opt_state): each parameter's `exp_avg`, `exp_avg_sq` and
        `step` (the count, as torch's Adam keeps it: a float32 scalar on the CPU,
        which its bias correction reads), then `count`, `lr` and `b1`. Raises
        ValueError on a tree of the other optimizer (adam / adamw) or whose moments
        are not laid out as `model`'s parameters."""
        inner = opt_state.get("inner_state", {})
        want = {"0", "1", "2"} if self.name == "adamw" else {"0", "1"}
        if set(inner) != want:
            raise ValueError(f"opt_state's inner state has entries {sorted(inner)}, not "
                             f"{self.name}'s {sorted(want)}")
        names = {id(p): n for n, p in model.named_parameters()}
        template, stats = torch_state_dict_to_flax(model.state_dict(),
                                                   torch_tree=not model.flax_counterpart)
        moments = {}
        for key, leaf in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            got, expected = _leaves(inner["0"][leaf]), _leaves(template)
            if got != expected:
                diff = sorted(set(got.items()) ^ set(expected.items()))[:4]
                raise ValueError(f"opt_state's {leaf} does not match the model's parameters "
                                 f"(path, shape) first differing: {diff}")
            moments[key] = flax_to_torch_state_dict(inner["0"][leaf], stats)
        count = int(np.asarray(opt_state["count"]))
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                n = names[id(p)]
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    **{k: torch.from_numpy(np.array(moments[k][n], dtype=np.float32)).to(
                        device=p.device) for k in ("exp_avg", "exp_avg_sq")}}
        hyper = opt_state["hyperparams"]
        self.count = count
        self.lr, self.b1 = np.float32(hyper["learning_rate"]), np.float32(hyper["b1"])


def _leaves(tree: dict, prefix: tuple = ()) -> dict[tuple, tuple]:
    """{path: shape} of a nested dict's array leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = tuple(np.shape(v))
    return out


def make_optimizer(params, total_steps: int, optimizer_name: str = "adam",
                   milestones=(0.0, 0.1, 0.7, 1.0), lrs=(3e-4, 3e-4, 3e-4, 1e-4),
                   moms=(0.9, 0.9, 0.9, 0.9), weight_decay: float = 0.01) -> ScheduledOptimizer:
    return ScheduledOptimizer(params, total_steps, optimizer_name, milestones, lrs, moms,
                              weight_decay)
