"""The port's spans (timg_tpu_torch/tracing.py) on the CPU: they record
only inside a torch.profiler session, nest by thread, count their work,
share ``time.perf_counter_ns``'s clock, change no byte of the output,
open no profiler range in anyone else's session, and land in the
Chrome trace that TIMG_TPU_PROFILE asks the CLI for."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

from timg_tpu_torch import models, tracing  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIXES = ("lib.", "window", "seq.")
LIB = ("lib.stage", "lib.resize", "lib.cells", "lib.fetch", "lib.emit")


def _frames(seed=3, b=3, h=30, w=44):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
    frames[1, ..., 3] = 128                  # a frame the compose blends
    return frames


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


@pytest.mark.parametrize("kind", ["quarter", "half"])
def test_no_spans_without_a_profiler(kind):
    model = models.get(kind)(out_h=10, out_w=20)
    assert model.render_batch(_frames())
    assert tracing.records() == []


@pytest.mark.parametrize("kind", ["quarter", "half"])
def test_library_batch_spans_nest_and_count(kind):
    frames = _frames()
    model = models.get(kind)(out_h=10, out_w=20)
    lo = tracing._now()
    with _cpu_profile():
        payloads = model.render_batch(frames)
    hi = tracing._now()
    recs = tracing.records()
    assert [r.name for r in recs if r.name == "lib.batch"] == ["lib.batch"]
    root = next(r for r in recs if r.name == "lib.batch")
    assert root.parent_id == 0 and root.count == len(frames)
    children = {r.name: r for r in recs if r.parent_id == root.span_id}
    assert sorted(children) == sorted(LIB)
    assert len(recs) == 1 + len(LIB)
    for r in recs:
        assert lo <= r.t0_ns <= r.t1_ns <= hi
        assert r.thread_id == root.thread_id
    for r in children.values():
        assert root.t0_ns <= r.t0_ns <= r.t1_ns <= root.t1_ns
    order = sorted(children.values(), key=lambda r: r.t0_ns)
    assert [r.name for r in order] == list(LIB)
    for a, b in zip(order, order[1:]):
        assert a.t1_ns <= b.t0_ns
    assert children["lib.stage"].count == frames.nbytes
    assert children["lib.resize"].count == len(frames)
    assert children["lib.emit"].count == len(payloads)
    per_frame = 10 // 2 * (20 // 2 if kind == "quarter" else 20)
    assert children["lib.cells"].count == len(frames) * per_frame
    glyph, fg, bg = model.process_batch(frames)
    assert children["lib.fetch"].count == (glyph.nbytes + fg.nbytes
                                           + bg.nbytes)


def test_payloads_equal_with_spans_on_and_off():
    frames = _frames(seed=5)
    model = models.get("quarter")(out_h=12, out_w=24,
                                  bg_color=(30, 60, 90, 255))
    off = model.render_batch(frames)
    with _cpu_profile():
        on = model.render_batch(frames)
    assert tracing.records()
    assert on == off


def test_no_program_range_in_an_outside_session():
    """A profiler session that is not the program's own holds no range of
    the program's: ranges would read as device work in its trace."""
    with _cpu_profile() as prof:
        models.get("quarter")(out_h=10, out_w=20).render_batch(_frames())
    assert tracing.records()
    keys = {e.key for e in prof.key_averages()}
    assert not [k for k in keys if k.startswith(PREFIXES)]


def test_off_spans_read_no_clock_and_allocate_nothing(monkeypatch):
    def clock():
        raise AssertionError("a span read the clock with spans off")

    monkeypatch.setattr(tracing, "_now", clock)
    first = tracing.span("lib.stage", 5)
    for _ in range(100):
        with tracing.span("lib.fetch") as s:
            s.count = 7
        assert s is first                   # one shared no-op context
    assert tracing.records() == []


def test_spans_nest_per_thread():
    import threading

    with _cpu_profile():
        with tracing.span("seq.put", 2) as outer:
            t = threading.Thread(target=lambda: tracing.span(
                "seq.write").__enter__().__exit__(None, None, None))
            t.start()
            t.join()
            with tracing.span("window.wait"):
                pass
    recs = {r.name: r for r in tracing.records()}
    assert recs["window.wait"].parent_id == outer.span_id
    assert recs["seq.write"].parent_id == 0        # another thread's root
    assert recs["seq.write"].thread_id != recs["seq.put"].thread_id
    assert recs["seq.put"].count == 2


def test_cap_counts_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    with _cpu_profile():
        for _ in range(5):
            with tracing.span("lib.emit"):
                pass
    assert len(tracing.records()) == 3 and tracing.dropped == 2
    tracing.clear()
    assert tracing.dropped == 0


def test_threads_lose_no_span(monkeypatch):
    """More threads than cores, switching often, past the cap: every
    span is kept or counted as dropped, each id once."""
    import threading

    monkeypatch.setattr(tracing, "CAP", 3000)
    interval = sys.getswitchinterval()
    threads = [threading.Thread(target=lambda: [
        tracing.span("seq.write").__enter__().__exit__(None, None, None)
        for _ in range(400)]) for _ in range(2 * os.cpu_count() + 4)]
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    recs = tracing.records()
    assert len(recs) == 3000
    assert len(recs) + tracing.dropped == 400 * len(threads)
    assert len({r.span_id for r in recs}) == len(recs)


def test_tracing_loads_nothing_of_torch():
    """Imported alone (the CLI's --help path), the module leaves torch
    unloaded, and its spans are off."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from timg_tpu_torch import tracing\n"
            "with tracing.span('seq.put'):\n"
            "    pass\n"
            "assert 'torch' not in sys.modules, 'torch loaded'\n"
            "assert tracing.records() == []\n"
            "import torch\n"
            "with torch.profiler.profile():\n"
            "    with tracing.span('seq.put'):\n"
            "        pass\n"
            "print(len(tracing.records()))\n" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-800:]
    assert out.stdout.strip() == "1"


def _y4m(path, w=48, h=32, n=11):
    rng = np.random.default_rng(4)
    with open(path, "wb") as f:
        f.write(("YUV4MPEG2 W%d H%d F25:1 Ip A1:1 C420jpeg\n"
                 % (w, h)).encode())
        for i in range(n):
            f.write(b"FRAME\n")
            f.write(np.full((h, w), 40 + 12 * i, np.uint8).tobytes())
            f.write(rng.integers(100, 160, (h // 2, w // 2),
                                 dtype=np.uint8).tobytes())
            f.write(np.full((h // 2, w // 2), 128, np.uint8).tobytes())
    return str(path)


@pytest.mark.parametrize("pixelation", ["-pq", "-ps"])
def test_cli_profile_writes_a_chrome_trace_with_the_spans(
        tmp_path, monkeypatch, capsys, pixelation):
    """TIMG_TPU_PROFILE on a video: the profiler's Chrome trace holds the
    window's spans (its worker thread's added on the trace's clock) and
    the sequencer's, with their counts; the stream is the one written
    without it."""
    from tests.test_torch_cli import _run_pty
    from timg_tpu_torch.cli import main
    from timg_tpu_torch.native import runtime

    if runtime.load_video() is None:
        pytest.skip("native video helper unavailable")
    clip = _y4m(tmp_path / "v.y4m")
    argv = [pixelation, "-g40x20", "--debug-no-frame-delay", "-b", "black",
            "--dither=cube", clip]
    monkeypatch.delenv("TIMG_TPU_PROFILE", raising=False)
    plain = _run_pty(main, argv, tmp_path / "a.out")
    assert tracing.records() == []
    monkeypatch.setenv("TIMG_TPU_PROFILE", str(tmp_path / "prof"))
    stream = _run_pty(main, argv, tmp_path / "b.out")
    assert stream == plain
    path, = glob.glob(str(tmp_path / "prof" / "timg-tpu-torch.*.trace.json"))
    assert f"torch profile written to {path}" in capsys.readouterr().err
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("name", "").startswith(PREFIXES)]
    names = {e["name"] for e in spans}
    assert {"window", "window.stack", "window.stage", "window.fetch",
            "window.wait", "window.emit", "seq.put",
            "seq.write"} <= names
    windows = [e for e in spans if e["name"] == "window"]
    assert sum(e["args"]["count"] for e in windows) == 11     # frames
    emitted = [e for e in spans if e["name"] == "window.emit"]
    assert sum(e["args"]["count"] for e in emitted) == 11
    writes = [e for e in spans if e["name"] == "seq.write"]
    assert sum(e["args"]["count"] for e in writes) == len(stream)
    # the worker's spans sit inside its window, on the trace's clock
    for e in spans:
        if e["name"] in ("window.stack", "window.stage"):
            w = next(w for w in windows if w["tid"] == e["tid"]
                     and w["ts"] <= e["ts"] <= w["ts"] + w["dur"])
            assert e["args"]["parent_id"] == w["args"]["span_id"]
    # each window's result reaches the main thread after the worker's
    # window ends: the two threads' spans on one clock (the tie of the
    # clocks is good to well under a millisecond)
    waits = sorted((e for e in spans if e["name"] == "window.wait"),
                   key=lambda e: e["ts"])
    assert len(waits) == len(windows)
    for w, wait in zip(sorted(windows, key=lambda e: e["ts"]), waits):
        assert w["ts"] + w["dur"] <= wait["ts"] + wait["dur"] + 1000
    assert tracing._range is None                  # the session closed
