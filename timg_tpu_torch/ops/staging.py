"""The library API's staging of a caller's host batch on a model's device
(``_BlockModel.process_batch`` and ``_PixelModel._to_device``).

What happens is chosen by what the input and the device are:

- a tensor already on the device, or any tensor bound for the CPU, goes
  through ``.to(device)`` (no copy where it is there already);
- a numpy batch bound for the CPU becomes a tensor over the same memory
  (``torch.from_numpy``; a strided batch is made contiguous first);
- a pinned, contiguous CPU tensor bound for a card is one ``non_blocking``
  copy on the model's copy stream;
- anything else bound for a card (numpy arrays, pageable tensors,
  contiguous or strided) crosses through the model's ring: two pinned
  host slots of ``chunk_frames`` frames each.  The host packs chunk c
  into slot c % 2 (one ``copy_``, which torch spreads over its intra-op
  threads) while the DMA of chunk c - 1 runs from the other slot on the
  copy stream.  Every byte of every batch crosses on every call.

No path waits for the batch to land: the compute stream waits for the
copy stream, so the kernels launched next read the batch once it has
landed, and the host waits only for a slot whose last DMA is still in
flight.  A ring-staged batch may be overwritten by its caller as soon as
this returns; a pinned one, as after any ``non_blocking`` copy, once the
card has read it.  The rates behind the design, on an H100's host
(PERF.md, Findings): pageable copies 6.2 GB/s; the pack 32-41 GB/s at
torch's default 8 intra-op threads and slower at 1, 2, 4 or 6; pinned
DMA 53.5 GB/s.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from timg_tpu_torch import tracing

SLOT_BYTES = 32 << 20     # a pinned slot: 4 frames of 1080p RGBA


def chunk_frames(frame_nbytes: int) -> int:
    """Frames a slot holds: the whole frames that fit in SLOT_BYTES, at
    least one."""
    return max(1, SLOT_BYTES // max(1, frame_nbytes))


def chunks(b: int, frame_nbytes: int) -> list:
    """(slot, first frame, frames) of each chunk of a batch of ``b``."""
    k = chunk_frames(frame_nbytes)
    return [(c % 2, i, min(k, b - i)) for c, i in enumerate(range(0, b, k))]


class Ring:
    """One model's staging on its device.  The pinned slots, the copy
    stream and the slots' events are allocated on the first batch that
    crosses to a card; a lock keeps two threads from interleaving
    slots."""

    def __init__(self, device: torch.device):
        self.device = device
        self._lock = threading.Lock()
        self._slots = ()
        self._stream = None
        self._events = ()

    def to_device(self, frames) -> torch.Tensor:
        """[B, ...] frames (numpy, or a tensor on any device) -> a tensor
        on the device, the ``lib.stage`` span (count: the bytes handed
        in)."""
        with tracing.span("lib.stage") as s:
            if not isinstance(frames, torch.Tensor):
                a = np.asarray(frames)
                if self.device.type != "cuda" or min(a.strides,
                                                     default=0) < 0:
                    a = np.ascontiguousarray(a)
                frames = torch.from_numpy(a)
            s.count = frames.nbytes
            if self.device.type != "cuda" or frames.device.type != "cpu" \
                    or frames.numel() == 0:
                return frames.to(self.device)
            with self._lock:
                if self._stream is None:
                    self._stream = torch.cuda.Stream(self.device)
                    self._events = torch.cuda.Event(), torch.cuda.Event()
                compute = torch.cuda.current_stream(self.device)
                out = torch.empty(frames.shape, dtype=frames.dtype,
                                  device=self.device)
                self._stream.wait_stream(compute)
                if frames.is_pinned() and frames.is_contiguous():
                    with torch.cuda.stream(self._stream):
                        out.copy_(frames, non_blocking=True)
                else:
                    self._through_slots(frames, out)
                compute.wait_stream(self._stream)
                out.record_stream(self._stream)
            return out

    def _through_slots(self, frames: torch.Tensor, out: torch.Tensor):
        frame_nbytes = frames.nbytes // frames.shape[0]
        need = chunk_frames(frame_nbytes) * frame_nbytes
        if not self._slots or self._slots[0].numel() < need:
            for e in self._events:
                e.synchronize()
            self._slots = tuple(torch.empty(need, dtype=torch.uint8,
                                            pin_memory=True)
                                for _ in range(2))
        for s, i, n in chunks(frames.shape[0], frame_nbytes):
            slot = self._slots[s][:n * frame_nbytes].view(
                frames.dtype).view(n, *frames.shape[1:])
            event = self._events[s]
            event.synchronize()    # the DMA that last read this slot
            with tracing.span("lib.pin", n * frame_nbytes):
                slot.copy_(frames[i:i + n])
            with torch.cuda.stream(self._stream):
                out[i:i + n].copy_(slot, non_blocking=True)
                event.record(self._stream)
