"""Hand-written CUDA kernels of the model stack, each with its plain torch
version."""
