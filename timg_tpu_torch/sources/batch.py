"""Cross-image grid batching: one device dispatch per geometry group
(counterpart of timg_tpu/sources/batch.py).

The reference fans per-image decode across threads and each image runs
its own scale (ref src/timg.cc:946-968); the contact sheet here instead
*batches* same-geometry grid cells through one resize+compose dispatch
on the device.

Mechanics: the CLI attaches a GridBatchCollector to DisplayOptions for
grid sessions. Still sources reaching pil_source._process_frames
register their raw frame and get a DeferredFrame ticket back instead
of a processed array; every decode-pool task reports completion via
``arrive()`` (success or not), and the last arrival flushes all
registered work grouped by (input shape, target) — one
_resize_compose per group, identical per-frame semantics (frames are
independent through resize; the lazy background compose is a byte
no-op on opaque frames). Block planes prime per group in one dispatch;
sixel planes prime per image (the adaptive palette is per image).
Presentation resolves tickets lazily in ImageSource.send_frames, so
decode keeps streaming while the presenter waits — pool threads never
block, which makes the rendezvous deadlock-free even with one worker.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np


class DeferredFrame:
    """Placeholder carried in PreprocessedFrame.frame until the
    collector flushes; resolves to the processed [H, W, 4] array."""

    def __init__(self, collector: "GridBatchCollector"):
        self._collector = collector
        self.value: Optional[np.ndarray] = None

    def get(self) -> np.ndarray:
        self._collector.wait_flushed()
        assert self.value is not None, "collector flush missed a ticket"
        return self.value


def resolve_frames(frames) -> None:
    """Swap DeferredFrame placeholders for their arrays (blocking).
    Called from ImageSource.send_frames before first use."""
    for pf in frames:
        if isinstance(pf.frame, DeferredFrame):
            pf.frame = pf.frame.get()


class GridBatchCollector:
    """Rendezvous for ``expected`` decode-pool tasks; flushes grouped
    device work when the last one arrives."""

    #: Failsafe: if arrivals are miscounted (a future bug), presenters
    #: force a flush after this long instead of hanging.
    WAIT_TIMEOUT_S = 60.0

    def __init__(self, expected: int):
        self._expected = expected
        self._arrived = 0
        self._lock = threading.Lock()
        self._flushed = threading.Event()
        # (in_shape, target_w, target_h) -> [(raw, ticket), ...]
        self._groups: dict = {}
        self._options = None

    def register(self, raw: np.ndarray, target_w: int, target_h: int,
                 options) -> Optional[DeferredFrame]:
        """Queue one still frame; returns its ticket (None = caller
        must process inline, e.g. registration after the flush)."""
        with self._lock:
            if self._flushed.is_set():
                return None
            ticket = DeferredFrame(self)
            key = (raw.shape, target_w, target_h)
            self._groups.setdefault(key, []).append((raw, ticket))
            self._options = options  # one shared options per session
            return ticket

    def arrive(self) -> None:
        """Called (via finally) when a decode-pool task completes."""
        with self._lock:
            self._arrived += 1
            if self._arrived >= self._expected:
                self._flush_locked()

    def wait_flushed(self) -> None:
        if not self._flushed.wait(self.WAIT_TIMEOUT_S):
            with self._lock:
                self._flush_locked()  # failsafe, see WAIT_TIMEOUT_S

    def _flush_locked(self) -> None:
        if self._flushed.is_set():
            return
        from timg_tpu_torch.render.plane_cache import (prime_block_planes,
                                                       prime_sixel_planes)
        from timg_tpu_torch.sources.pil_source import _resize_compose
        for (shape, tw, th), entries in self._groups.items():
            raws: List[np.ndarray] = [e[0] for e in entries]
            processed, batch = _resize_compose(raws, tw, th, self._options)
            for (_, ticket), arr in zip(entries, processed):
                ticket.value = arr
            # Block planes: one dispatch for the whole group. Sixel
            # planes: per image (adaptive palettes are per image --
            # sharing the batch's first-frame palette would change
            # bytes vs the unbatched path).
            prime_block_planes(processed, self._options, batch=batch)
            if getattr(self._options, "sixel_batch_dither", None):
                for i, arr in enumerate(processed):
                    prime_sixel_planes([arr], self._options, {},
                                       batch=batch[i:i + 1])
            del processed, batch
        self._groups.clear()
        self._flushed.set()
