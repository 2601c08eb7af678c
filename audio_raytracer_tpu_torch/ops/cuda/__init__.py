"""The hand-written CUDA kernels (csrc/) and the backend that runs them."""
