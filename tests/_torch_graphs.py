"""Graphs shared by the PyTorch-port tests.  This module imports neither
JAX nor the JAX package, so the card-only tests (``test_torch_cuda.py``)
can use it where only PyTorch is installed."""
import numpy as np


def tactic_mix_edges(n: int = 64, b: int = 4) -> np.ndarray:
    """A graph whose plan takes all three tactics under psi='cyclic' (a copy
    of the JAX package's ``tests/test_planner.py::_tactic_mix_edges``): a
    clique over the vertices congruent 0 mod b (one fully dense block) and a
    ring, which touches only the (i, i) and (i, i+1) block pairs and leaves
    the rest structurally empty."""
    ids0 = np.arange(0, n, b)
    clique = np.array([(s, d) for s in ids0 for d in ids0])
    ring = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
    return np.concatenate([clique, ring])
