"""The per-layer metrics that read the library staging's pinned ring
(``lib.pin`` spans, timg_tpu_torch/ops/staging.py): absent where no batch
crosses through the ring, as on the CPU, and read from a hand-made span
list as the bytes and seconds of the spans that began in the window."""

from types import SimpleNamespace

import pytest
from test_harness import run

CELL = "lib-quarter-film-b32"
READERS = ("pin_gbps.lib", "staged_pinned_pct.lib")


def test_traced_cpu_run_leaves_the_pin_readers_out(tiny, cpu_device):
    from timg_tpu_torch import tracing

    tracing.clear()
    result = run(tiny(CELL), trace=1)
    assert result["correct"], result["check"]
    metrics = result["metrics"]
    assert metrics["stage_gbps.lib"]["value"] > 0
    for name in READERS:
        assert name not in metrics


def _read(recs, t0, t1, trace=True):
    from harness import spec
    from timg_tpu_torch import tracing

    tracing.clear()
    tracing._records.extend(recs)
    r = SimpleNamespace(t0=t0, t1=t1,
                        trace=SimpleNamespace() if trace else None)
    try:
        return [spec.metric_module(name).read(r) for name in READERS]
    finally:
        tracing.clear()


def test_pin_readers_read_the_ring_spans():
    """A window [100, 1000): two batches staged, the first through the
    ring in two chunks, the second (a device tensor) not; a chunk that
    began after the window is left out."""
    from timg_tpu_torch import tracing

    Rec = tracing.Record
    recs = [Rec("lib.stage", 100, 400, 0, 1, 1000, 7),
            Rec("lib.pin", 110, 210, 1, 2, 400, 7),
            Rec("lib.pin", 220, 320, 1, 3, 600, 7),
            Rec("lib.stage", 500, 520, 0, 4, 3000, 7),
            Rec("lib.stage", 1000, 1200, 0, 5, 800, 7),
            Rec("lib.pin", 1010, 1110, 5, 6, 800, 7)]
    pin, share = _read(recs, 100, 1000)
    assert pin == pytest.approx(1000 / 200)        # bytes over ns: GB/s
    assert share == pytest.approx(100.0 * 1000 / 4000)
    assert _read(recs, 100, 1000, trace=False) == [None, None]


def test_pin_readers_read_nothing_without_ring_spans():
    """Stage spans alone (a program without the ring, or the CPU): both
    readers give nothing."""
    from timg_tpu_torch import tracing

    recs = [tracing.Record("lib.stage", 100, 400, 0, 1, 1000, 7)]
    assert _read(recs, 0, 1000) == [None, None]
