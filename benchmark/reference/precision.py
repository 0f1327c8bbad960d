"""The precision of the reference's float stages.

The configuration states float32 arithmetic for the resize, the
compose and the block cells (the reference viewer's C code computes in
``float``).  ``F32`` computes in it.  ``BF16`` is the
control of the comparison: every float32 result of those stages is
rounded to bfloat16 (nearest, ties to even), the step below float32 that
a later change could be tempted to take.
"""

from __future__ import annotations

import numpy as np


def round_bf16(x) -> np.ndarray:
    """float32 -> the nearest bfloat16 value (ties to even), as float32;
    the rounding of ``torch.Tensor.to(torch.bfloat16)``."""
    a = np.ascontiguousarray(x, dtype=np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).reshape(a.shape)


class Precision:
    """``r(x)`` rounds a float32 intermediate to this precision."""

    def __init__(self, name: str):
        if name not in ("f32", "bf16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def r(self, x):
        return x if self.name == "f32" else round_bf16(x)


F32 = Precision("f32")
BF16 = Precision("bf16")
