"""The CRNN a request, ms: CUDA events from forward hooks on the `SeldNet`
(encoder, BiGRU, heads)."""


def read(run):
    ms, n = run.spans.get("crnn", (0.0, 0))
    return ms / n if n else None
