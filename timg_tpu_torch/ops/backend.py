"""The one torch.device this process computes on.

``cuda`` unless ``TIMG_TPU_TORCH_DEVICE=cpu`` is set.  On ``cpu`` every
kernel wrapper runs its plain PyTorch version (the CPU tests and the
byte-reference runs use that); on ``cuda`` it launches the hand-written
kernel.  There is no fallback from one to the other: asking for ``cuda``
on a machine without a usable card is an error, never a silent switch.
"""

from __future__ import annotations

import os

import torch

ENV = "TIMG_TPU_TORCH_DEVICE"


def device() -> torch.device:
    """The device named by TIMG_TPU_TORCH_DEVICE (default ``cuda``)."""
    name = os.environ.get(ENV, "cuda").strip().lower() or "cuda"
    if name not in ("cuda", "cpu"):
        raise RuntimeError(f"{ENV}={name!r}: expected 'cuda' or 'cpu'")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"timg-tpu-torch: CUDA is not available (torch "
            f"{torch.__version__}); set {ENV}=cpu to run the plain "
            "PyTorch versions on the CPU")
    return torch.device(name)
