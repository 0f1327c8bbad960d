"""The per-layer metrics that read the program's own spans
(timg_tpu_torch/tracing.py), in a traced run on the CPU: the host
readings come back, the device ones give nothing without device
activity, and the program's spans stay out of the harness's session."""

import pytest
from test_harness import run

CELL = "lib-quarter-film-b32"


def test_traced_run_reads_the_program_spans(tiny, cpu_device):
    from timg_tpu_torch import tracing

    tracing.clear()
    result = run(tiny(CELL), trace=1)
    assert result["correct"], result["check"]
    metrics = result["metrics"]
    assert metrics["stage_gbps.lib"]["value"] > 0
    assert metrics["stage_gbps.lib"]["unit"] == "GB/s"
    assert metrics["fetch_wait_ms_per_frame.lib"]["value"] > 0
    assert not any(k.startswith("idle_in_") for k in metrics)
    names = {k for k, _ in result["breakdown"]["device_ops"]}
    assert not any(n.startswith(("lib.", "window.", "seq."))
                   for n in names)


def test_untraced_run_records_no_spans(tiny, cpu_device):
    from timg_tpu_torch import tracing

    tracing.clear()
    result = run(tiny(CELL), seconds=0.5)
    assert result["correct"]
    assert tracing.records() == []


def test_idle_readers_split_the_gaps_by_innermost_span():
    """A hand-made trace: the card idle in [0, 100) and [150, 300) of a
    window [0, 400); lib.emit [50, 200) holds a child [60, 80)."""
    from types import SimpleNamespace

    from harness import spec
    from timg_tpu_torch import tracing

    tracing.clear()
    Rec = tracing.Record
    recs = [Rec("lib.emit", 50, 200, 0, 1, 4, 7),
            Rec("lib.inner", 60, 80, 1, 2, 0, 7),
            Rec("lib.resize", 250, 350, 0, 3, 4, 7)]
    trace = SimpleNamespace(intervals=[(100, 150, "k"), (300, 400, "k")],
                            gaps=lambda: [(0, 100), (150, 300)])
    r = SimpleNamespace(t0=0, t1=400, seconds=400 / 1e9, trace=trace)
    tracing._records.extend(recs)
    try:
        emit = spec.metric_module("idle_in_emit_pct.lib").read(r)
        resize = spec.metric_module("idle_in_resize_pct.lib").read(r)
    finally:
        tracing.clear()
    # emit: [50, 60) and [80, 100) and [150, 200) idle = 80 of 400
    assert emit == pytest.approx(100.0 * 80 / 400)
    # resize: [250, 300) idle = 50 of 400
    assert resize == pytest.approx(100.0 * 50 / 400)
