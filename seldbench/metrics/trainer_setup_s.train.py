"""The trainer's set-up, s: the host seconds of the program's `setup.trainer`
span (the whole of `SeldTrainer.__init__`, which ends once the device work it
queued is done), from its aggregate, over its count (one trainer a run).
Nothing where the program records no such span."""


def read(run):
    try:
        from salsa_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    n, seconds = span_totals().get("setup.trainer", (0, 0.0))
    return seconds / n if n else None
