"""Shared inputs for the port's parity tests (``tests/test_torch_*.py``)."""

import numpy as np


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
