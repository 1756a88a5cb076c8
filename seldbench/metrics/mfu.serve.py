"""The serving window's share of the card's fp32 peak, %: the CRNN's operations
of every request, counted from its shapes (`work.mfu_percent`)."""

from seldbench.work import MFU_NOTE as NOTE  # noqa: F401
from seldbench.work import mfu_percent as read  # noqa: F401
