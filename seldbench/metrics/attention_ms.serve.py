"""Attention a request, ms: the device time of the program's `model.attention`
spans (each self-attention of a transformer stack: q/k/v projection, scores,
softmax, their product with v, output projection; CUDA events inside
`SelfAttention.forward`) under its `serve.request` roots, over the number of
those roots. Nothing where the program records no such span."""


def read(run):
    try:
        from salsa_tpu_torch.utils.profiling import span_records
    except ImportError:
        return None
    records = span_records()
    roots = {r.id for r in records if r.name == "serve.request" and r.parent is None}
    ms = [r.device_ms for r in records if r.name == "model.attention" and r.root in roots]
    if not roots or not ms or None in ms:
        return None
    return sum(ms) / len(roots)
