"""The port's video window (timg_tpu_torch.render.plane_cache) against the
JAX package's device window on the CPU.

The JAX side runs under TIMG_TPU_FORCE_DEVICE=1 (its Pallas dither in
interpret mode) with the plane transport, so both sides hand the canvas
raw index planes; planes, palettes and frame pixels must be identical,
in the cube, libsixel and adaptive modes.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

from timg_tpu.options import DisplayOptions  # noqa: E402
from timg_tpu.render import plane_cache as jcache  # noqa: E402
from timg_tpu_torch.render import plane_cache as tcache  # noqa: E402


def _window(seed, b, h, w):
    rng = np.random.default_rng(seed)
    ys = rng.integers(16, 236, (b, h, w), dtype=np.uint8)
    us = rng.integers(16, 240, (b, (h + 1) // 2, (w + 1) // 2),
                      dtype=np.uint8)
    vs = rng.integers(16, 240, (b, (h + 1) // 2, (w + 1) // 2),
                      dtype=np.uint8)
    return ys, us, vs


def _opts(mode="cube", bg=(0, 0, 0, 255)):
    opts = DisplayOptions()
    opts.sixel_batch_dither = mode
    opts.bgcolor_getter = (lambda: bg) if bg is not None else None
    return opts


@pytest.fixture
def jax_device_window(monkeypatch):
    """The JAX package's device window on the CPU, plane transport."""
    monkeypatch.setenv("TIMG_TPU_FORCE_DEVICE", "1")
    monkeypatch.setenv("TIMG_TPU_SIXEL_TRANSPORT", "plane")
    monkeypatch.delenv("TIMG_TPU_VIDEO_DEVICE_WINDOW", raising=False)


def _pop_equal(got, want, th, tw):
    """Pop each frame's primed entry from both caches and compare;
    returns the port's (palette, quantizer) of the last frame."""
    assert len(got) == len(want)
    for g, j in zip(got, want):
        assert isinstance(g, tcache.DeviceFrame)
        assert g.shape == j.shape == (th, tw, 4)
        gp, gpal, gq = tcache.SIXEL_PLANES.pop(g)
        jp, jpal, jq = jcache.SIXEL_PLANES.pop(j)
        assert gp.dtype == np.uint8
        np.testing.assert_array_equal(gp, np.asarray(jp))
        np.testing.assert_array_equal(np.asarray(g), np.asarray(j))
        assert (gpal is None) == (jpal is None)
        if gpal is not None:
            np.testing.assert_array_equal(gpal, jpal)
        assert (gq is None) == (jq is None)
        if gq is not None:
            for a, b in zip(gq, jq):
                np.testing.assert_array_equal(a, np.asarray(b))
    return gpal, gq


@pytest.mark.parametrize("h,w,th,tw,full_range,bg", [
    (48, 64, 22, 40, False, (0, 0, 0, 255)),     # 22 -> 24: opaque bg pad
    (48, 64, 22, 40, True, (200, 150, 255, 255)),  # bg word with bit 31
    (36, 50, 24, 30, True, None),                # no pad rows
    (24, 32, 30, 44, False, (0, 0, 0, 0)),       # upscale; transparent bg
])
def test_prime_sixel_video_matches_jax(jax_device_window, h, w, th, tw,
                                       full_range, bg):
    ys, us, vs = _window(h * w + th, 3, h, w)
    want = jcache.prime_sixel_video_device(ys, us, vs, th, tw, full_range,
                                           _opts(bg=bg), {})
    got = tcache.prime_sixel_video_device(ys, us, vs, th, tw, full_range,
                                          _opts(bg=bg), {})
    assert len(got) == 3
    assert _pop_equal(got, want, th, tw) == (None, None)   # cube palette


def test_prime_pad_rows_carry_bg_word():
    """The opaque-bg pad rows hold the wrapped int32 RGBA word."""
    ys, us, vs = _window(2, 2, 20, 32)
    state = {}
    tcache.prime_sixel_video_device(ys, us, vs, 10, 32, True,
                                    _opts(bg=(1, 2, 3, 255)), state)
    words = state["video_stage"][1](*[torch.from_numpy(p)
                                      for p in (ys, us, vs)])
    assert words.shape == (2, 12, 32)
    want = np.array([[1, 2, 3, 255]], np.uint8).view(np.int32)[0, 0]
    assert (words[:, 10:].numpy() == want).all()


def test_video_stage_reused_per_geometry():
    ys, us, vs = _window(3, 2, 24, 32)
    state = {}
    tcache.prime_sixel_video_device(ys, us, vs, 12, 16, False, _opts(), state)
    stage = state["video_stage"]
    tcache.prime_sixel_video_device(ys, us, vs, 12, 16, False, _opts(), state)
    assert state["video_stage"] is stage
    tcache.prime_sixel_video_device(ys, us, vs, 18, 16, False, _opts(), state)
    assert state["video_stage"] is not stage
    assert isinstance(state["video_stage"][1], torch.nn.Module)


def _mixed_window(seed, b, h, w):
    """Noise in even frames (more than 256 sampled buckets: libsixel
    diffuses) and smooth gradients in odd ones (fewer: palette only)."""
    ys, us, vs = _window(seed, b, h, w)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(1, b, 2):
        ys[i] = 30 + (xx * 150 // w + yy * 40 // h + 9 * i) % 200
        us[i], vs[i] = 128, 140
    return ys, us, vs


@pytest.mark.parametrize("h,w,th,tw,full_range,bg,mixed", [
    (96, 128, 46, 64, False, (0, 0, 0, 255), True),  # 46 -> 48 bg pad
    (96, 128, 46, 64, True, (200, 150, 255, 255), True),
    (72, 100, 48, 60, True, None, False),            # no pad rows
])
def test_prime_libsixel_matches_jax(jax_device_window, h, w, th, tw,
                                    full_range, bg, mixed):
    """Per-frame palettes from the padded frames' histogram samples,
    bucket tables and the table dither: planes and palettes equal."""
    make = _mixed_window if mixed else _window
    ys, us, vs = make(h * w + th, 4, h, w)
    want = jcache.prime_sixel_video_device(
        ys, us, vs, th, tw, full_range, _opts("libsixel", bg), {})
    got = tcache.prime_sixel_video_device(
        ys, us, vs, th, tw, full_range, _opts("libsixel", bg), {})
    pal, quantizer = _pop_equal(got, want, th, tw)
    assert pal is not None and quantizer is None


def test_prime_adaptive_two_windows_matches_jax(jax_device_window):
    """One tree per video, from the first window's first frame, kept in
    the state for the second window: planes, palette and tree equal."""
    jstate, tstate = {}, {}
    for k, seed in enumerate((40, 41)):
        ys, us, vs = _window(seed, 3, 48, 64)
        if k:
            ys = ys // 2 + 60            # other colors than the tree's
        want = jcache.prime_sixel_video_device(
            ys, us, vs, 22, 40, False, _opts("adaptive"), jstate)
        got = tcache.prime_sixel_video_device(
            ys, us, vs, 22, 40, False, _opts("adaptive"), tstate)
        _, quantizer = _pop_equal(got, want, 22, 40)
        assert quantizer is tstate["quantizer"]
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(tstate["quantizer"], jstate["quantizer"]))


@pytest.mark.parametrize("mode", ["auto", None])
def test_other_dithers_not_yet_ported(mode):
    """Only resolved modes reach the window (the CLI resolves auto)."""
    ys, us, vs = _window(4, 1, 12, 16)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tcache.prime_sixel_video_device(ys, us, vs, 6, 8, False,
                                        _opts(mode), {})


def test_sws_resample_not_yet_ported(jax_device_window):
    """--resample=sws-bitexact's window, refused until the sws kernel
    was ported, now runs and equals the JAX package's device window (the
    other windows and geometries: tests/test_torch_sws.py)."""
    ys, us, vs = _window(5, 1, 12, 16)
    want = jcache.prime_sixel_video_device(ys, us, vs, 6, 8, False, _opts(),
                                           {}, resample="sws")
    got = tcache.prime_sixel_video_device(ys, us, vs, 6, 8, False, _opts(),
                                          {}, resample="sws")
    _pop_equal(got, want, 6, 8)


def test_device_frame_materializes_one_frame():
    words = torch.arange(2 * 4 * 6, dtype=torch.int32).reshape(2, 4, 6)
    f = tcache.DeviceFrame(words, 1, 3, 6)
    arr = np.asarray(f)
    assert arr.shape == f.shape == (3, 6, 4) and arr.dtype == np.uint8
    np.testing.assert_array_equal(
        arr, words[1, :3].numpy().view(np.uint8).reshape(3, 6, 4))


def test_canvas_assembles_primed_planes():
    """The canvas pops the primed plane and writes one sixel image, equal
    to assembling that plane with the cube palette; a frame that was not
    primed takes the single-frame route (the still path's), and writes
    the JAX canvas's bytes."""
    from timg_tpu.ops.sixel_np import cube_palette
    from timg_tpu.options import SixelOptions
    from timg_tpu.render.sequencer import SeqType
    from timg_tpu.render.sixel_render import SixelCanvas as JaxCanvas
    from timg_tpu.render.sixel_render import encode_sixel_stream
    from timg_tpu_torch.render.sixel_render import SixelCanvas

    class Sink:
        def __init__(self):
            self.data = []

        def write_buffer(self, buf, seq_type, end_ms):
            self.data.append(buf)

    ys, us, vs = _window(6, 2, 24, 32)
    opts = _opts()
    opts.cell_x_px, opts.cell_y_px = 8, 16
    frames = tcache.prime_sixel_video_device(ys, us, vs, 10, 16, False,
                                             opts, {})
    plane = tcache.SIXEL_PLANES.pop(frames[0])[0]
    sink = Sink()
    canvas = SixelCanvas(sink, SixelOptions(), opts, dither="cube")
    canvas.send(0, 0, frames[0], SeqType.FRAME_IMMEDIATE)
    out = b"".join(sink.data)
    assert out.count(b"\033Pq") == 1
    assert encode_sixel_stream(plane, cube_palette()) in out
    unprimed = np.asarray(frames[0]).copy()
    want = Sink()
    JaxCanvas(want, SixelOptions(), opts, dither="cube").send(
        0, 0, unprimed, SeqType.FRAME_IMMEDIATE)
    sink.data.clear()
    canvas.send(0, 0, unprimed, SeqType.FRAME_IMMEDIATE)
    assert b"".join(sink.data) == b"".join(want.data)
    assert b"".join(sink.data).count(b"\033Pq") == 1


def _block_opts(cell_x):
    opts = _opts(None)
    opts.cell_x_px, opts.cell_y_px = cell_x, 2
    return opts


@pytest.mark.parametrize("use_upper", [False, True])
@pytest.mark.parametrize("th,tw", [(20, 30), (21, 30), (17, 26)])
@pytest.mark.parametrize("cell_x", [2, 1])
def test_prime_block_video_matches_jax(jax_device_window, monkeypatch,
                                       cell_x, th, tw, use_upper):
    """The block window, quarter and half, at even and odd heights, over
    two windows (the second's frame 0 diffs against the first's tail):
    every primed plane, the diff masks and the frame pixels equal the
    JAX device window's, and the canvas's identity check holds across
    the windows."""
    if use_upper:
        monkeypatch.setenv("TIMG_USE_UPPER_BLOCK", "1")
    jstate, tstate = {}, {}
    tail_obj = None
    for k, seed in enumerate((60, 61)):
        ys, us, vs = _window(seed + th, 3, 40, 56)
        for c, p in enumerate((ys, us, vs)):
            if k:
                p[0] = last[c]            # frame 0 repeats the tail
            p[1, :len(p[1]) // 2] = p[0, :len(p[1]) // 2]   # a top repeats
        tail = [p[-1].copy() for p in (ys, us, vs)]
        want = jcache.prime_block_video_device(
            ys, us, vs, th, tw, False, _block_opts(cell_x), jstate)
        got = tcache.prime_block_video_device(
            ys, us, vs, th, tw, False, _block_opts(cell_x), tstate)
        assert want is not None and len(got) == len(want) == 3
        for i, (g, j) in enumerate(zip(got, want)):
            assert g.shape == j.shape == (th, tw, 4)
            np.testing.assert_array_equal(np.asarray(g), np.asarray(j))
            gp, gg, gf, gb, gprev, geq = tcache.BLOCK_PLANES.pop(g)
            jp, jg, jf, jb, jprev, jeq = jcache.BLOCK_PLANES.pop(j)
            assert gp.shape == jp.shape == (th + th % 2, tw, 4)
            np.testing.assert_array_equal(np.asarray(gp), np.asarray(jp))
            for a, b in ((gg, jg), (gf, jf), (gb, jb)):
                np.testing.assert_array_equal(a, b)
            assert (geq is None) == (jeq is None) == (k == 0 and i == 0)
            if geq is not None:
                np.testing.assert_array_equal(geq, jeq)
                if i == 0:                # the repeated tail
                    assert geq.all()
                elif i == 1:              # the repeated top
                    assert geq.any() and not geq.all()
            assert gprev is (tail_obj if i == 0 else prev_padded)
            prev_padded = gp
        tail_obj, last = prev_padded, tail


def test_block_window_declines_odd_width_quarter():
    ys, us, vs = _window(62, 2, 24, 32)
    assert tcache.prime_block_video_device(
        ys, us, vs, 12, 15, False, _block_opts(2), {}) is None
    assert tcache.prime_block_video_device(
        ys, us, vs, 12, 15, False, _block_opts(1), {}) is not None


def test_device_frame_reads_blank_rows_outside_the_words():
    """A padded frame's rows outside the words (the odd-height pad row)
    read as zero words, on top (y0 = -1) or at the bottom."""
    words = torch.arange(1, 2 * 3 * 2 + 1, dtype=torch.int32).reshape(2, 3, 2)
    top = np.asarray(tcache.DeviceFrame(words, 1, 4, 2, -1))
    bottom = np.asarray(tcache.DeviceFrame(words, 1, 4, 2))
    w = words[1].numpy()
    assert top.shape == bottom.shape == (4, 2, 4)
    np.testing.assert_array_equal(top.view(np.int32)[..., 0],
                                  np.concatenate([[[0, 0]], w]))
    np.testing.assert_array_equal(bottom.view(np.int32)[..., 0],
                                  np.concatenate([w, [[0, 0]]]))
    assert tcache.DeviceFrame(words, 0, 4, 2).reshape(2, 2, 2, 1, 4).shape \
        == (2, 2, 2, 1, 4)


@pytest.mark.parametrize("quarter,upper,c256", [(True, False, False),
                                                (True, True, True),
                                                (False, False, False)])
def test_block_canvas_single_frame_route_matches_jax(quarter, upper, c256):
    """Frames that no window primed (odd-width quarter frames take this
    route in the video source) go through the canvas's single-frame
    route: widened, padded to an even height, the block op on one frame,
    the diff against the previous frame on the host.  Three frames of
    odd width and height, the later ones repeating part of the first:
    the stream equals the JAX canvas's."""
    from timg_tpu.render.ansi import UnicodeBlockCanvas as JCanvas
    from timg_tpu.render.sequencer import SeqType
    from timg_tpu_torch.render import ansi as tansi

    class Sink:
        def __init__(self):
            self.data = []

        def write_buffer(self, buf, seq_type, end_ms):
            self.data.append(buf)

    rng = np.random.default_rng(63)
    frames = rng.integers(0, 256, (3, 11, 15, 4), dtype=np.uint8)
    frames[..., 3] = 255
    frames[1, :6] = frames[0, :6]
    frames[2] = frames[1]
    outs = []
    before = dict(tansi.EMITTED)
    for cls in (JCanvas, tansi.UnicodeBlockCanvas):
        sink = Sink()
        canvas = cls(sink, use_quarter=quarter, use_upper_half_block=upper,
                     use_256_color=c256)
        for i, f in enumerate(frames):
            canvas.send(2, -11 if i else 0, f.copy(),
                        SeqType.ANIMATION_FRAME)
        outs.append(sink.data)
    assert outs[1] == outs[0]
    assert outs[1][2] == b""          # an unchanged frame writes nothing
    assert sum(tansi.EMITTED.values()) - sum(before.values()) == 3


def test_block_window_spans_stage_and_fetch():
    """Under a profiler session the block window records its staging
    (the planes' bytes) and its one fetch of the cells (their bytes),
    and the frames are those of a window without spans."""
    from timg_tpu_torch import tracing

    ys, us, vs = _window(63, 3, 24, 32)
    tracing.clear()
    off = tcache.prime_block_video_device(ys, us, vs, 12, 16, False,
                                          _block_opts(2), {})
    assert tracing.records() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = tcache.prime_block_video_device(ys, us, vs, 12, 16, False,
                                             _block_opts(2), {})
    recs = {r.name: r for r in tracing.records()}
    tracing.clear()
    assert sorted(recs) == ["window.fetch", "window.stage"]
    assert recs["window.stage"].count == ys.nbytes + us.nbytes + vs.nbytes
    planes = [tcache.BLOCK_PLANES.pop(f) for f in on]
    # glyph, fg and bg of each frame, and the diff masks of all three
    # (frame 0's, against no tail, is fetched but not handed on)
    assert recs["window.fetch"].count == sum(
        p[k].nbytes for p in planes for k in (1, 2, 3)) + len(on) * \
        planes[1][5].nbytes
    assert recs["window.stage"].t1_ns <= recs["window.fetch"].t0_ns
    for a, b in zip(off, on):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        tcache.BLOCK_PLANES.pop(a)
