"""Hand-written CUDA kernels for Hopper, their launchers and plain versions."""
