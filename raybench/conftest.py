"""The benchmark's tests: `python -m pytest raybench -q` from the
repository's root.  Tests marked `card` need a CUDA card; each decides so
inside itself and skips here with its reason."""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
