"""Regenerate tests/golden/orbax_small/: a small checkpoint that salsa_tpu's orbax
backend wrote (`orbax_small.orbax`, zstd at orbax's level), the msgpack of the
same payload (`orbax_small.msgpack`) and their sidecar. The port reads it
without orbax on a host that has no way to write real zstd.

    JAX_PLATFORMS=cpu python tests/golden/make_orbax_small.py [--full-width DIR]

With `--full-width DIR` it writes instead, into DIR (not committed: about 140
MB), salsa_tpu's `.orbax` of configs/seld.yml's network at full width with seeded
normal weights and Adam moments, which
`python -m salsa_tpu_torch.scripts.bench_restore DIR/full_width.orbax` times.

The small payload is made from a seed: float32 normal arrays in conv, GRU and Dense
shapes (one conv kernel of 36864 values spans two zstd blocks), BatchNorm
statistics, and Adam's state as salsa_tpu's optimizer lays it out (count,
injected hyperparameters, mu and nu, and optax's EmptyState), at step 7.
"""
from __future__ import annotations

import os
import sys
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "orbax_small")
NAME = "orbax_small"
SEED = 20261018


def payload_state():
    """(params, batch_stats, opt_state, step) as salsa_tpu's TrainState holds them."""
    from salsa_tpu.train.state import make_optimizer

    rng = np.random.default_rng(SEED)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    params = {"encoder": {"Conv_0": {"kernel": normal(3, 3, 7, 16)},
                          "Conv_1": {"kernel": normal(3, 3, 64, 64)},
                          "BatchNorm_0": {"scale": normal(16), "bias": normal(16)}},
              "decoder": {"gru": {"wi": normal(64, 96), "wh": normal(32, 96),
                                  "bi": normal(96), "bh": normal(96)},
                          "event_fc": {"kernel": normal(64, 12), "bias": normal(12)}}}
    stats = {"encoder": {"BatchNorm_0": {"mean": normal(16),
                                         "var": np.abs(normal(16)) + np.float32(0.5)}}}
    opt = make_optimizer(10).init(params)
    adam = opt.inner_state[0]
    moments = {k: {"mu": normal(*v.shape), "nu": np.abs(normal(*v.shape))}
               for k, v in _flat(params).items()}
    adam = adam._replace(count=np.int32(7), mu=_unflat({k: m["mu"] for k, m in moments.items()}),
                         nu=_unflat({k: m["nu"] for k, m in moments.items()}))
    opt = opt._replace(count=np.int32(7), inner_state=(adam, *opt.inner_state[1:]))
    return params, stats, opt, 7


def full_width_state():
    """configs/seld.yml's network (PannResNet22 + bigru 256, 12 classes) with seeded
    normal weights, BatchNorm statistics and Adam moments, at step 1000."""
    import jax
    import jax.numpy as jnp
    import yaml

    from salsa_tpu.models import seld
    from salsa_tpu.train.state import make_optimizer

    with open(os.path.join(os.path.dirname(os.path.dirname(HERE)), "configs", "seld.yml")) as f:
        cfg = yaml.safe_load(f)
    model = seld.build_model(encoder=cfg["model"]["encoder"], decoder=cfg["model"]["decoder"],
                             n_classes=cfg["data"]["n_classes"])
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 7, 64, 32)), train=False)
    rng = np.random.default_rng(SEED)

    def normal(scale, positive=False):
        def leaf(a):
            x = (scale * rng.standard_normal(a.shape)).astype(np.float32)
            return np.abs(x) + np.float32(0.5) if positive else x
        return leaf

    params = jax.tree_util.tree_map(normal(0.05), variables["params"])
    stats = jax.tree_util.tree_map(normal(1.0, positive=True), variables["batch_stats"])
    opt = make_optimizer(10).init(params)
    adam = opt.inner_state[0]._replace(count=np.int32(1000),
                                       mu=jax.tree_util.tree_map(normal(1e-3), params),
                                       nu=jax.tree_util.tree_map(normal(1e-6), params))
    opt = opt._replace(count=np.int32(1000), inner_state=(adam, *opt.inner_state[1:]))
    return params, stats, opt, 1000


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, (*prefix, k)))
        else:
            out[(*prefix, k)] = v
    return out


def _unflat(flat):
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def write(out_dir: str, full_width: bool = False) -> dict:
    """Both checkpoints and their sidecar into `out_dir` (the full-width state's
    `.orbax` alone with `full_width`): {backend: path}."""
    from salsa_tpu.train import checkpoint as jckpt

    params, stats, opt, step = full_width_state() if full_width else payload_state()
    state = types.SimpleNamespace(step=step, params=params, batch_stats=stats, opt_state=opt)
    meta = {"epoch": 3, "valSeld": 0.25}
    name, backends = ("full_width", ("orbax",)) if full_width else (NAME, ("orbax", "msgpack"))
    return {backend: jckpt.save_checkpoint(out_dir, name, state, meta, backend=backend)
            for backend in backends}


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import shutil

    if sys.argv[1:2] == ["--full-width"]:
        print(write(sys.argv[2], full_width=True))
    else:
        shutil.rmtree(OUT, ignore_errors=True)
        print(write(OUT))
