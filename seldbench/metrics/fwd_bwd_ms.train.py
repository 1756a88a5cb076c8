"""Forward and backward a step, ms: CUDA events around
`trainer.forward_backward` (the training-mode CRNN, `seld_loss`, autograd)."""


def read(run):
    ms, n = run.spans.get("forward_backward", (0.0, 0))
    return ms / n if n else None
