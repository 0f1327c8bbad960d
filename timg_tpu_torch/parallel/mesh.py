"""Frame-pipeline sharding over a grid of cards (counterpart of
timg_tpu/parallel/mesh.py).

Two kinds of parallelism, as in the JAX package:

* **data**: the frame batch [B, ...] split over the grid's ``data``
  axis; each card runs the whole per-frame pipeline on its slice of the
  frames of a video window or a contact sheet;
* **space**: the image height split over the ``space`` axis for very
  large frames.  The JAX package lets GSPMD exchange the halo the
  vertical resize taps need; here each card is handed its band of output
  rows and the input rows those rows' taps read, and the stb resize
  computes a band's rows in the whole frame's order
  (ops/resize.py ``resize_batch_rows``), so the bands join into the
  whole frame's bytes.

No card talks to another: each shard's result is copied back to the
host and joined there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from timg_tpu_torch.ops import backend
from timg_tpu_torch.ops import blocks as blocks_op
from timg_tpu_torch.ops import compose as compose_op
from timg_tpu_torch.ops import resize as resize_op
from timg_tpu_torch.ops.resize import resize_video_words
from timg_tpu_torch.ops.sixel_kernel import fs_dither_cube_fused
from timg_tpu_torch.ops.yuv import yuv420_to_rgba_words
from timg_tpu_torch.parallel import auto


class Mesh:
    """A ``(data, space)`` grid of torch devices (a card may repeat)."""

    axis_names = ("data", "space")

    def __init__(self, devices: np.ndarray):
        self.devices = devices        # object array [data, space]

    @property
    def shape(self) -> tuple:
        return self.devices.shape


def visible_devices() -> List[torch.device]:
    """Every card of the process's device type (the one CPU device on
    the CPU)."""
    dev = backend.device()
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              devices: Optional[Sequence[torch.device]] = None,
              repeat: bool = False) -> Mesh:
    """A (data, space) grid over the first n of ``devices`` (default the
    visible ones).  With ``repeat`` the devices are taken round and round
    when n exceeds them (one card standing in for four); otherwise n may
    not exceed them.  ``data`` defaults to the JAX package's choice:
    data parallelism first, space gets the rest."""
    pool = list(devices) if devices is not None else visible_devices()
    n = n_devices or len(pool)
    if n > len(pool) and not repeat:
        raise ValueError(f"make_mesh: {n} devices asked for, "
                         f"{len(pool)} visible")
    if data is None:
        data = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                data = n // cand
                break
    space = n // data
    grid = np.empty(data * space, dtype=object)
    for i in range(data * space):
        grid[i] = pool[i % len(pool)]
    return Mesh(grid.reshape(data, space))


def _cell_bands(rows: int, space: int) -> list:
    """``space`` bands of output rows, each an even number of rows (a
    cell is two rows)."""
    edges = 2 * np.linspace(0, rows // 2, space + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def sharded_quarter_pipeline(mesh: Mesh, out_h: int, out_w: int,
                             use_upper_half_block: bool = False):
    """The quarter pipeline (ops/pipeline.py ``quarter_pipeline`` with
    an opaque black background) with the batch split over ``data`` and
    the output height over ``space``.  Returns ``fn(frames)``: [B, H, W,
    4] uint8 (host or any device) -> (glyph int32, fg, bg uint8) on the
    host, equal to the unsharded pipeline's planes."""
    bands = _cell_bands(out_h, mesh.shape[1])
    black = (0, 0, 0, 255)

    def band_planes(frames, o0: int, o1: int, dev):
        in_h = frames.shape[1]
        i0, i1 = resize_op.input_rows(in_h, out_h, o0, o1)
        y = resize_op.resize_batch_rows(auto.to_device(frames[:, i0:i1], dev),
                                        in_h, out_h, out_w, i0, o0, o1)
        # no checkerboard: each pixel blends with the black alone
        y = compose_op.alpha_compose_background(y, black, (0, 0, 0, 0),
                                                pattern_w=2, pattern_h=1)
        return blocks_op.quarter_blocks(
            y, use_upper_half_block=use_upper_half_block)

    def fn(frames):
        planes = auto.band_grid_call(mesh.devices, frames, bands,
                                     band_planes)
        return tuple(torch.from_numpy(p) for p in planes)

    return fn


def sharded_video_sixel_pipeline(mesh: Mesh, out_h: int, out_w: int,
                                 yuv: bool = False,
                                 full_range: bool = True):
    """The video sixel path (words -> resize -> FS cube dither -> index
    planes; with ``yuv`` the 4:2:0 planes convert first) with the frame
    batch split over the ``data`` axis: each card of the grid's first
    column runs the whole per-shard pipeline on its slice.  Returns
    ``fn(words)`` or ``fn(y, u, v)`` -> [B, out_h, out_w] uint8 indices
    on the host."""
    devices = list(mesh.devices[:, 0])

    def per_shard(*args):
        words = yuv420_to_rgba_words(*args, full_range) if yuv else args[0]
        resized = resize_video_words(words, out_h, out_w)
        return fs_dither_cube_fused(resized, out_h, out_w, out_u8=True)

    def fn(*args):
        return torch.from_numpy(auto.shard_batch_call(
            ("video_sixel", out_h, out_w, yuv, full_range), per_shard,
            list(args), devices=devices))

    return fn
