"""Data-parallel training across processes (counterpart of `salsa_tpu.parallel`)."""
