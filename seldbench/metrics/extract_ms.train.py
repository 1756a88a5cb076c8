"""The trainer's batch a step, ms: CUDA events around `trainer.batch` (the chunk
gather, the DFT matmul, K2 resumed from the tracker checkpoints, K1, the
normalisation and the valid-frame mask)."""


def read(run):
    ms, n = run.spans.get("batch", (0.0, 0))
    return ms / n if n else None
