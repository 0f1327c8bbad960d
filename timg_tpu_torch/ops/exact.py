"""The exact floor root the repacks take (counterpart of
timg_tpu/ops/exact.py).

The reference repacks a linear color with ``(uint8)min(sqrtf(v), 255)``
(ref src/framebuffer.h:150-152, 169-172).  The JAX package computes
that as an exact floor root, ``floor_sqrt_255``, because the TPU's sqrt
is approximate.  Here the root takes no sqrt at all: ``torch.sqrt`` on
the CPU now and then returned a root about 150 ulps low on the card's
host (ROADMAP, faults: the quarter stream), and a truncated root then
writes n - 1.  Truncating a correctly rounded root equals the floor root
on every value the repacks feed it (the blend lattice rn(m)/255 and the
block averages keep at least 1/510 below any n^2; see the JAX module's
docstring), which tests/test_torch_stills.py enumerates for the compose.

The JAX module's other function, ``rn_div``, has no twin: torch's ``/``
rounds correctly on the CPU and on CUDA when the divisor is a tensor on
the dividend's device (a Python scalar divisor on CUDA becomes a
reciprocal multiply).
"""

from __future__ import annotations

import torch


def floor_sqrt_255(v: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(v)) for float32 0 <= v < 65536 (at most 255), by
    bisection on exact squares (each candidate's square is an integer
    below 2^24, so the product and the compare are exact)."""
    r = torch.zeros_like(v)
    for bit in (128.0, 64.0, 32.0, 16.0, 8.0, 4.0, 2.0, 1.0):
        c = r + bit
        r = torch.where(c * c <= v, c, r)
    return r
