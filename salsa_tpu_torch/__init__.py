"""PyTorch/CUDA port of the SALSA-FOA serving path of `salsa_tpu`.

The port runs on one NVIDIA Hopper GPU. Module names follow `salsa_tpu`, so the
counterpart of `salsa_tpu_torch.features.salsa` is `salsa_tpu.features.salsa`.
The two hot spots of SALSA extraction are hand-written CUDA kernels
(`csrc/salsa_spatial.cu`, `csrc/noise_floor.cu`), built with nvcc at first use;
on CPU tensors their wrappers run the plain PyTorch versions beside them.
`cli.predict` serves a trained `salsa_tpu` experiment from disk and `cli.evaluate`
scores what it writes.

The package imports torch, numpy, scipy and the standard library only: no jax,
flax, yaml, msgpack, h5py or `salsa_tpu`. It carries its own copies of what it
needs from `salsa_tpu`: the weight converter (`interop.py`), a reader for the
YAML of configs, a msgpack codec for flax checkpoints, WAV I/O and the scorers.
"""
