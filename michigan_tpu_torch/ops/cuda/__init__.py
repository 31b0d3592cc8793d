"""Hand-written CUDA kernels (``michigan_tpu_torch/csrc``) and their wrappers."""
