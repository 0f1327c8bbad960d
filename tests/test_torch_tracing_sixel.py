"""The sixel model's spans (timg_tpu_torch/tracing.py) on the CPU: under
a profiler session ``render_batch`` opens ``lib.batch`` with the
staging, the resize, the dither, the fetch and the assembly as its
children, each with its count; ``lib.palette`` opens once a stream with
``adaptive_reuse`` and once a frame without; with no session no span
records."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

from timg_tpu_torch import models, tracing  # noqa: E402

OUT_H, OUT_W = 14, 22
LIB = ("lib.stage", "lib.resize", "lib.dither", "lib.fetch", "lib.emit")


def _frames(seed=5, b=3, h=30, w=44):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
    frames[1, ..., 3] = 128                  # a frame the compose blends
    return frames


def _model(**kw):
    return models.get("sixel")(out_h=OUT_H, out_w=OUT_W, **kw)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


MODES = [dict(dither="adaptive", adaptive_reuse=True),
         dict(dither="adaptive"), dict(dither="cube")]


@pytest.mark.parametrize("mode", MODES)
def test_no_spans_without_a_profiler(mode):
    assert _model(**mode).render_batch(_frames())
    assert tracing.records() == []


def _batch(recs):
    roots = [r for r in recs if r.name == "lib.batch"]
    assert len(roots) == 1 and roots[0].parent_id == 0
    root = roots[0]
    children = [r for r in recs if r.parent_id == root.span_id]
    for r in children:
        assert root.t0_ns <= r.t0_ns <= r.t1_ns <= root.t1_ns
        assert r.thread_id == root.thread_id
    return root, children


def test_reuse_batch_spans_nest_and_count():
    frames = _frames()
    model = _model(dither="adaptive", adaptive_reuse=True)
    with _profile():
        payloads = model.render_batch(frames)
    recs = tracing.records()
    root, children = _batch(recs)
    assert root.count == len(frames)
    names = [r.name for r in sorted(children, key=lambda r: r.t0_ns)]
    assert names == ["lib.stage", "lib.resize", "lib.palette",
                     "lib.dither", "lib.fetch", "lib.emit"]
    by = {r.name: r for r in children}
    px = OUT_H * OUT_W
    assert by["lib.stage"].count == frames.nbytes
    assert by["lib.resize"].count == len(frames)
    assert by["lib.palette"].count == px
    assert by["lib.dither"].count == len(frames) * px
    assert by["lib.fetch"].count == len(frames) * px   # uint8 indices
    assert by["lib.emit"].count == len(payloads) == len(frames)
    order = sorted(children, key=lambda r: r.t0_ns)
    for a, b in zip(order, order[1:]):
        assert a.t1_ns <= b.t0_ns


def test_reuse_opens_the_palette_once_a_stream():
    model = _model(dither="adaptive", adaptive_reuse=True)
    with _profile():
        for seed in range(3):
            model.render_batch(_frames(seed))
    recs = tracing.records()
    assert [r.name for r in recs].count("lib.batch") == 3
    assert [r.name for r in recs].count("lib.palette") == 1
    for name in LIB:
        assert [r.name for r in recs].count(name) == 3
    model.reset_palette()
    tracing.clear()
    with _profile():
        model.render_batch(_frames())
    assert [r.name for r in tracing.records()].count("lib.palette") == 1


def test_a_tree_a_frame_opens_the_palette_a_frame():
    frames = _frames()
    with _profile():
        _model(dither="adaptive").render_batch(frames)
    root, children = _batch(tracing.records())
    names = [r.name for r in children]
    for name in ("lib.palette", "lib.dither", "lib.fetch"):
        assert names.count(name) == len(frames)
    assert names.count("lib.emit") == 1
    assert all(r.count == OUT_H * OUT_W for r in children
               if r.name in ("lib.palette", "lib.dither", "lib.fetch"))


def test_cube_has_no_palette_span():
    frames = _frames()
    with _profile():
        _model(dither="cube").render_batch(frames)
    root, children = _batch(tracing.records())
    assert sorted(r.name for r in children) == sorted(LIB)


@pytest.mark.parametrize("mode", MODES)
def test_spans_change_no_byte(mode):
    frames = _frames()
    plain = _model(**mode).render_batch(frames)
    with _profile():
        traced = _model(**mode).render_batch(frames)
    assert traced == plain


def test_yuv_batch_opens_the_batch_span():
    rng = np.random.default_rng(9)
    y = rng.integers(0, 256, (2, 30, 44), dtype=np.uint8)
    u = rng.integers(0, 256, (2, 15, 22), dtype=np.uint8)
    model = _model(dither="adaptive", adaptive_reuse=True)
    with _profile():
        model.render_batch_yuv(y, u, u.copy())
    root, children = _batch(tracing.records())
    assert root.count == 2
    assert {"lib.dither", "lib.fetch", "lib.emit"} <= {
        r.name for r in children}


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_a_batch_opens_an_assemble_span_a_payload(mode, b):
    """One ``lib.emit`` on the caller's thread (count: payloads), and a
    ``lib.assemble`` a payload (count: its bytes) on the thread that
    assembled it: over the pool, with no parent; at width 1, inside
    ``lib.emit`` on the caller's thread."""
    import threading

    from timg_tpu_torch.render import sixel_render

    with _profile():
        payloads = _model(**mode).render_batch(_frames()[:b])
    recs = tracing.records()
    root, _ = _batch(recs)
    [emit] = [r for r in recs if r.name == "lib.emit"]
    assert emit.count == b and emit.parent_id == root.span_id
    assert emit.thread_id == threading.get_native_id()
    assembled = [r for r in recs if r.name == "lib.assemble"]
    assert sorted(r.count for r in assembled) == sorted(map(len, payloads))
    for r in assembled:
        assert emit.t0_ns <= r.t0_ns <= r.t1_ns <= emit.t1_ns
    if min(sixel_render._host_cpus(), b) > 1:
        assert all(r.parent_id == 0 for r in assembled)
        assert emit.thread_id not in {r.thread_id for r in assembled}
    else:
        assert [(r.parent_id, r.thread_id) for r in assembled] == [
            (emit.span_id, emit.thread_id)] * b
