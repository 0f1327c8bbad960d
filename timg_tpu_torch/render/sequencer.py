"""Output pacing engine: bounded write queue with frame timing.

Behavioral spec: ref src/buffered-write-sequencer.{h,cc}. A dedicated
writer thread drains a FIFO of (buffer-or-future, SeqType, end_of_frame):

* ControlWrite     -- always written, even after an interrupt;
* FrameImmediate   -- written as soon as dequeued;
* StartOfAnimation -- stamps t0 of the animation;
* AnimationFrame   -- sleeps until t0 + end_of_frame (no skew buildup),
                      skipped when > 250 ms behind and skipping is allowed
                      (ref buffered-write-sequencer.cc:115-133).

The queue is bounded (default 4, ref timg.cc:972) with producer
backpressure. This same discipline double-buffers the host->device handoff
in the TPU pipeline.
"""

from __future__ import annotations

import enum
import os
import threading
import time
from concurrent.futures import Future
from queue import Queue
from typing import Union

from timg_tpu_torch import tracing

_ALLOWED_SKEW_MS = 250.0  # ref buffered-write-sequencer.cc:121


class SeqType(enum.Enum):
    CONTROL_WRITE = 0
    FRAME_IMMEDIATE = 1
    START_OF_ANIMATION = 2
    ANIMATION_FRAME = 3


class BufferedWriteSequencer:
    def __init__(
        self,
        fd: int,
        allow_frame_skipping: bool = False,
        max_queue_len: int = 4,
        debug_no_frame_delay: bool = False,
        interrupt_flag=None,
    ):
        self._fd = fd
        self._allow_skip = allow_frame_skipping
        self._debug_no_delay = debug_no_frame_delay
        self._interrupt = interrupt_flag or (lambda: False)
        self._queue: Queue = Queue(maxsize=max_queue_len)
        self.max_queue_len = max_queue_len

        self._stats_lock = threading.Lock()
        self.bytes_total = 0
        self.bytes_skipped = 0
        self.frames_total = 0
        self.frames_skipped = 0

        self._thread = threading.Thread(target=self._process_queue, daemon=True)
        self._thread.start()

    def write_buffer(
        self,
        block: Union[bytes, Future],
        seq_type: SeqType,
        end_of_frame_ms: float = 0.0,
    ) -> None:
        # the producer blocks here while the queue is full
        with tracing.span("seq.put", self._queue.qsize()):
            self._queue.put((block, seq_type, end_of_frame_ms))

    def _process_queue(self) -> None:
        animation_start = 0.0
        last_frame_end_ms = 0.0
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                block, seq_type, end_of_frame_ms = item
                if isinstance(block, Future):
                    try:
                        block = block.result()
                    except Exception:
                        # A failed async encode must not kill the
                        # writer thread: the bounded queue would then
                        # deadlock every producer.  Drop the frame and
                        # keep draining.  TIMG_TPU_DEBUG_ENCODE_ERRORS=1
                        # surfaces the swallowed traceback on stderr.
                        if os.environ.get("TIMG_TPU_DEBUG_ENCODE_ERRORS"):
                            import sys
                            import traceback
                            traceback.print_exc(file=sys.stderr)
                        continue
                if block is None:  # flush sentinel
                    continue

                if self._interrupt() and seq_type != SeqType.CONTROL_WRITE:
                    continue  # discard queued frames (ref :108-111)

                do_skip = False
                if seq_type == SeqType.START_OF_ANIMATION:
                    animation_start = time.monotonic()
                elif seq_type == SeqType.ANIMATION_FRAME:
                    if last_frame_end_ms > 0:
                        finish_time = animation_start + last_frame_end_ms / 1000.0
                        now = time.monotonic()
                        do_skip = (
                            self._allow_skip
                            and finish_time + _ALLOWED_SKEW_MS / 1000.0 < now
                        )
                        if not self._debug_no_delay and finish_time > now:
                            time.sleep(finish_time - now)
                last_frame_end_ms = end_of_frame_ms

                if not do_skip:
                    with tracing.span("seq.write", len(block)):
                        _reliable_write(self._fd, block)

                if seq_type != SeqType.CONTROL_WRITE:
                    with self._stats_lock:
                        self.bytes_total += len(block)
                        self.frames_total += 1
                        if do_skip:
                            self.bytes_skipped += len(block)
                            self.frames_skipped += 1
            finally:
                self._queue.task_done()

    def flush(self) -> None:
        """Block until every queued buffer hit the fd (ref :148-158)."""
        self.write_buffer(b"", SeqType.CONTROL_WRITE)
        self._queue.join()

    def shutdown(self) -> None:
        if not self._thread.is_alive():     # shut down already
            return
        self.flush()
        self._queue.put(None)
        self._thread.join()


def _reliable_write(fd: int, buffer: bytes) -> None:
    """Partial-write retry loop (ref buffered-write-sequencer.cc:58-68).

    The reference's loop silently stops on write() <= 0; Python's
    os.write raises instead (e.g. BrokenPipeError when the reader of a
    `timg ... | head` pipe exits).  Match the C semantics: stop writing
    but keep the writer thread alive so the queue keeps draining and
    shutdown() completes instead of deadlocking."""
    view = memoryview(buffer)
    while view:
        try:
            written = os.write(fd, view)
        except BlockingIOError:
            # Served sessions run the client's tty non-blocking (see
            # serve._RequestGuard) so a wedged client that never drains
            # its terminal cannot block the resident process forever:
            # wait for writability in slices, honoring the interrupt
            # flag the serve watchdog (or the client's death) sets.
            import select

            from timg_tpu_torch import cli
            if cli.interrupt_received:
                return
            try:
                select.select([], [fd], [], 0.2)
            except OSError:
                return
            continue
        except OSError:
            return
        if written <= 0:
            return
        view = view[written:]
