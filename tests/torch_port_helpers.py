"""Shared inputs and fixtures for the port's parity tests (``tests/test_torch_*.py``)."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one intra-op thread while a test runs, the count before
    restored after.  The tier-1 suite runs six workers on the host's cores;
    each on every core oversubscribes them, and a test of thousands of
    small ops then runs tens of times slower.  A test file imports this
    fixture to have it (autouse applies it to every test of the file)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def randomize_abn(tree, rs):
    """Copy of a Flax variable tree with every ABN vector redrawn.

    Conv kernels are kept; ``scale``, ``bias``, ``mean`` and ``var`` of the
    norm layers get seeded values away from 1 and 0, so folding or eps
    mistakes cannot hide behind the initial mean 0 and var 1.
    """
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize_abn(v, rs)
            continue
        a = np.asarray(v, np.float32)
        if a.ndim == 1 and k == "scale":
            a = rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif a.ndim == 1 and k in ("bias", "mean"):
            a = rs.uniform(-0.3, 0.3, a.shape).astype(np.float32)
        elif a.ndim == 1 and k == "var":
            a = rs.uniform(0.5, 2.0, a.shape).astype(np.float32)
        out[k] = a
    return out
