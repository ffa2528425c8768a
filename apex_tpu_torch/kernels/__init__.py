"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (see ``kernels/landmark_blocks.py``)."""
