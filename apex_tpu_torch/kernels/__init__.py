"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``landmark_blocks``, ``spd_inverse``); the CUDA graph builder that
jit mode's conditional nodes need (``graph_conditional``); and their shared
``nvcc`` build (``build``)."""
