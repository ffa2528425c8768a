"""The benchmark's own tests: the harness and its reference on the CPU at
small sizes, and (marked ``cuda``) one short run on a card.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture(autouse=True)
def one_thread():
    """One BLAS thread per test process: small solves beside other workers
    run many times slower with more."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip where the machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
