"""Autograd's backward a step, ms: the device time of the program's
`train.backward` spans (CUDA events around `total.backward()` in
`SeldTrainer.forward_backward`) under its `train.step` roots, over the number
of those roots. Nothing where the program records no such span."""


def read(run):
    try:
        from salsa_tpu_torch.utils.profiling import span_records
    except ImportError:
        return None
    records = span_records()
    roots = {r.id for r in records if r.name == "train.step" and r.parent is None}
    ms = [r.device_ms for r in records if r.name == "train.backward" and r.root in roots]
    if not roots or not ms or None in ms:
        return None
    return sum(ms) / len(roots)
