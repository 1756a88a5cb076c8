"""Feature extraction a request, ms: CUDA events around each call of the
pipeline's extractor (STFT, log spectrograms, and for SALSA K2 and K1)."""


def read(run):
    ms, n = run.spans.get("features", (0.0, 0))
    return ms / n if n else None
