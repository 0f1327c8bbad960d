"""Device->host transport of dither planes (counterpart of
timg_tpu/ops/sixel_runs.py, plane transport only).

The JAX package can also ship column-run records or device-emitted DCS
bytes and picks per window; those transports come in a later slice.
The transport never changes the stream's bytes, only what crosses the
link: here every window ships its [h, w] uint8 index planes, in one
copy per window.
"""

from __future__ import annotations

import numpy as np
import torch

# Transport accounting: the JAX package's own counters (a jax-free
# module), so the CLI's --verbose report reads the port's traffic too.
from timg_tpu.ops.sixel_runs import STATS  # noqa: F401


def fetch_planes_or_runs(planes_dev: torch.Tensor, n_frames: int, h: int,
                         w: int) -> list:
    """[B, >=h, >=w] uint8 planes on the device -> list of n_frames host
    [h, w] uint8 planes (one device->host copy for the window)."""
    full = planes_dev[:n_frames, :h, :w].cpu().numpy()
    STATS["frames_plane"] += n_frames
    STATS["bytes_shipped"] += h * w * n_frames
    STATS["bytes_plane_equiv"] += h * w * n_frames
    return [np.ascontiguousarray(full[i]) for i in range(n_frames)]
