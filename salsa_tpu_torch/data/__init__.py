"""Split loading for training (counterpart of `salsa_tpu.data`)."""
