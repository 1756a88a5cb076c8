"""Build and bind the package's CUDA kernels (`csrc/*.cu`)."""
