"""The training window's share of the card's fp32 peak, %: three forward passes'
operations a step (forward, and backward for activations and weights), counted
from the batch's shapes (`work.mfu_percent`)."""

from seldbench.work import MFU_NOTE as NOTE  # noqa: F401
from seldbench.work import mfu_percent as read  # noqa: F401
