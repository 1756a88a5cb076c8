"""Trained `salsa_tpu` experiments: msgpack checkpoints and the tuned threshold."""
