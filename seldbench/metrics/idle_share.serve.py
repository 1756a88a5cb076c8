"""The card's idle share of a serving cell's traced window, %
(`tracing.idle_percent`)."""

from seldbench.tracing import idle_percent as read  # noqa: F401
