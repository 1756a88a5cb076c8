"""Adam's step a step, ms: the device time of the program's `train.optimizer`
spans (CUDA events around `self.optimizer.step()` in `SeldTrainer.step_on`)
under its `train.step` roots, over the number of those roots. Nothing where the
program records no such span."""


def read(run):
    try:
        from salsa_tpu_torch.utils.profiling import span_records
    except ImportError:
        return None
    records = span_records()
    roots = {r.id for r in records if r.name == "train.step" and r.parent is None}
    ms = [r.device_ms for r in records if r.name == "train.optimizer" and r.root in roots]
    if not roots or not ms or None in ms:
        return None
    return sum(ms) / len(roots)
