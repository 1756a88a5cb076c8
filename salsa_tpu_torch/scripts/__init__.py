"""Probes of the port's kernels on the card (counterparts of `scripts/probe_*.py`)."""
