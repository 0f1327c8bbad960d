"""Routing of the CLI's frame-batch work over cards (counterpart of
timg_tpu/parallel/auto.py).

The JAX package shards the frame axis of each sustained dispatch (video
windows, animation windows, batched dither planes) over a 1-D
``('data',)`` mesh with ``shard_map``; here each shard is a slice of the
batch copied to its own card, where the same kernels run on it.  Frames
are independent through convert, resize, dither and the block cells, so
no card talks to another and the gathered result is the single-device
result byte for byte (tests/test_torch_multichip_cli.py).

Opt-in: ``--devices N|auto`` on the CLI or ``TIMG_TPU_DEVICES`` in the
environment.  The cards are ``cuda:0 .. cuda:k-1``, k clamped to
``torch.cuda.device_count()`` as the JAX package clamps to
``jax.devices()``; on the CPU (``TIMG_TPU_TORCH_DEVICE=cpu``) they are n
shards of the one CPU device, so the routing runs in the CPU tests.  By
default the session is single-device: every function here returns None
and callers run their unsharded dispatch.

A shard that fails raises: nothing falls back to one card.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from timg_tpu_torch.ops import backend

# key -> the device of each shard of the key's last call, in batch order
# (the devices phase of chip_smoke.py prints them)
SHARDS: dict = {}


def configured_devices() -> int:
    """Requested device count: TIMG_TPU_DEVICES = int | 'auto' (every
    visible card; 1 on the CPU)."""
    spec = os.environ.get("TIMG_TPU_DEVICES", "1").strip().lower()
    if spec in ("auto", "all"):
        try:
            if backend.device().type == "cuda":
                return max(1, torch.cuda.device_count())
        except RuntimeError:
            pass
        return 1
    try:
        return max(1, int(spec))
    except ValueError:
        return 1


def data_devices() -> Optional[List[torch.device]]:
    """The configured cards, or None when the session is single-device
    (the default, or one visible card)."""
    n = configured_devices()
    if n <= 1:
        return None
    dev = backend.device()
    if dev.type != "cuda":
        return [dev] * n
    n = min(n, torch.cuda.device_count())
    if n <= 1:
        return None
    return [torch.device("cuda", i) for i in range(n)]


def on(dev: torch.device):
    """Make ``dev`` the current card while open (a no-op on the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def to_device(a, dev: torch.device) -> torch.Tensor:
    """A tensor or numpy array on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _map(fn: Callable, out):
    """``fn`` over a tensor or a tuple / list of tensors (None kept)."""
    if isinstance(out, (tuple, list)):
        return type(out)(None if t is None else fn(t) for t in out)
    return fn(out)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def shard_batch_call(key: tuple, fn, batch_args: Sequence,
                     rep_args: Sequence = (), fetch: bool = True,
                     devices: Optional[Sequence[torch.device]] = None):
    """Run ``fn(*batch_args, *rep_args)`` with every batch arg's leading
    axis split over the cards; None when single-device (callers then run
    their unsharded dispatch).

    * ``key`` names the call (``SHARDS[key]`` records its shards' cards).
    * The batch is padded to a multiple of the card count with repeats
      of its last frame, and the outputs are sliced back: frames are
      independent, so the padding cannot change the kept results.
    * Each shard is copied to its card and ``rep_args`` (palette tables
      etc.) once to each card; every shard is issued before any is
      waited on.
    * ``fetch=True`` gathers the outputs to the host (numpy, or a tuple
      of numpy arrays); ``fetch=False`` returns the list of each shard's
      outputs, left on its card, padding sliced off (shards of padding
      alone dropped), so callers can run follow-up dispatches (the sixel
      transport decision) on each card before any copy back.
    * ``devices`` overrides the configured cards (a card may repeat).
    """
    devs = list(devices) if devices is not None else data_devices()
    if devs is None:
        return None
    n = len(devs)
    b = batch_args[0].shape[0]
    pad = (-b) % n
    per = (b + pad) // n

    def shard(a, i):
        part = a[i * per:(i + 1) * per]
        short = per - part.shape[0]
        if short:               # repeats of the last frame
            last = a[b - 1:b]
            if isinstance(a, torch.Tensor):
                part = torch.cat([part] + [last] * short)
            else:
                part = np.concatenate([part] + [last] * short)
        return part

    reps = {}
    outs = []
    for i, dev in enumerate(devs):
        if dev not in reps:
            reps[dev] = [to_device(r, dev) for r in rep_args]
        with on(dev):
            args = [to_device(shard(a, i), dev) for a in batch_args]
            outs.append(fn(*args, *reps[dev]))
    SHARDS[key] = [str(d) for d in devs]
    keep = [min(per, max(0, b - i * per)) for i in range(n)]
    if not fetch:
        return [_map(lambda t, k=k: t[:k], out)
                for out, k in zip(outs, keep) if k]
    hosts = [_map(_host, out) for out in outs]
    if isinstance(hosts[0], (tuple, list)):
        return tuple(np.concatenate([h[j] for h in hosts])[:b]
                     for j in range(len(hosts[0])))
    return np.concatenate(hosts)[:b]


# Frames at or above this area take the spatial route when the batch is
# smaller than the card count (the JAX package's threshold): one 4K
# still then uses every card instead of one.
_SPATIAL_MIN_PIXELS = 2048 * 2048


def spatial_shard_call(key: tuple, fn, batch, out_h: int,
                       in_rows: Callable[[int, int], tuple],
                       min_pixels: int = _SPATIAL_MIN_PIXELS,
                       devices: Optional[Sequence[torch.device]] = None
                       ) -> Optional[np.ndarray]:
    """The ``('data', 'space')`` route for very large frames: the batch
    split over ``data`` and the OUTPUT rows over ``space``.

    Each card gets a band of ``out_h``'s rows and the input rows
    ``in_rows(o0, o1) -> (i0, i1)`` that those rows' vertical taps read
    (the halo), and computes ``fn(band, i0, o0, o1)``: output rows
    ``o0 .. o1`` from input rows ``i0 .. i1``.  The bands are gathered
    to the host in order.  ``fn`` must compute each output row from its
    taps alone, elementwise, so a band writes the bytes the whole frame
    would (the stb resize: ops/resize.py ``resize_batch_rows``).

    Applies only when it beats plain data parallelism: more than one
    card, frames of at least ``min_pixels``, fewer frames than cards.
    Returns None otherwise."""
    devs = list(devices) if devices is not None else data_devices()
    if devs is None:
        return None
    n = len(devs)
    b, h, w = batch.shape[:3]
    if b >= n or h * w < min_pixels:
        return None
    data = next(c for c in range(min(b, n), 0, -1) if n % c == 0)
    space = n // data
    bounds = np.linspace(0, out_h, space + 1).astype(int)
    bands = [(int(a), int(c)) for a, c in zip(bounds[:-1], bounds[1:])
             if c > a]

    def band(chunk, o0, o1, dev):
        i0, i1 = in_rows(o0, o1)
        return fn(to_device(chunk[:, i0:i1], dev), i0, o0, o1)

    grid = [devs[d * space:(d + 1) * space] for d in range(data)]
    SHARDS[key] = [str(x) for x in devs]
    return band_grid_call(grid, batch, bands, band)


def band_grid_call(grid: Sequence[Sequence[torch.device]], batch,
                   bands: Sequence[tuple], band_fn: Callable):
    """The ``(data, space)`` grid's loop, shared by the spatial route
    and parallel/mesh.py: the batch's frames split over the grid's rows
    (``data``) and the output rows over its columns (``space``).  Card
    ``grid[d][s]`` computes ``band_fn(chunk, o0, o1, dev)`` for the d-th
    slice of frames and the s-th band ``(o0, o1)`` of output rows
    (``band_fn`` picks the input rows its taps read).  Every band is
    issued before any is fetched; the outputs come back as numpy arrays
    (a tuple when ``band_fn`` returns one), bands joined along the rows
    and slices along the frames."""
    issued = []
    for d, idx in enumerate(np.array_split(np.arange(batch.shape[0]),
                                           len(grid))):
        if not len(idx):
            continue
        chunk = batch[int(idx[0]):int(idx[-1]) + 1]
        row = []
        for (o0, o1), dev in zip(bands, grid[d]):
            with on(dev):
                row.append(band_fn(chunk, o0, o1, dev))
        issued.append(row)
    rows = [[_map(_host, out) for out in row] for row in issued]
    if isinstance(rows[0][0], (tuple, list)):
        return tuple(np.concatenate([np.concatenate([o[k] for o in row],
                                                    axis=1) for row in rows])
                     for k in range(len(rows[0][0])))
    return np.concatenate([np.concatenate(row, axis=1) for row in rows])
