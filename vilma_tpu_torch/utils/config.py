"""Global numeric configuration (port of vilma_tpu/utils/config.py).

The reference clamps probabilities at EPSILON=1e-100 (reference
numerics.py:8). That underflows to 0 in float32, so the clamp is
dtype-dependent: 1e-100 at float64, 1e-30 at float32.
"""
import torch

_EPS_BY_DTYPE = {
    torch.float64: 1e-100,
    torch.float32: 1e-30,
}


def epsilon(dtype):
    """Return the numerical fudge factor appropriate for torch `dtype`."""
    return _EPS_BY_DTYPE[dtype]
