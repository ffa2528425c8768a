"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``landmark_blocks``, ``spd_inverse``); the CUDA graph builder that
jit mode's conditional nodes need (``graph_conditional``); the tracer's
device phase stamps (``trace_stamp``, for ``utils.profiling``); and their
shared ``nvcc`` build (``build``)."""
