"""The port's kitty and iTerm2 modules (timg_tpu_torch.render.png,
.kitty, .iterm2, models.get("kitty"/"iterm2") and the pixel video
window) against the JAX package on the CPU.

Tolerance everywhere: byte equality.  Kitty image ids are seeded from
the clock, so both packages' id state is pinned.  The JAX package's
video window runs under TIMG_TPU_FORCE_DEVICE=1 (its device path on
XLA:CPU), the port's with TIMG_TPU_TORCH_DEVICE=cpu (the kernels' plain
versions).
"""

import os
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

from timg_tpu import models as jmodels  # noqa: E402
from timg_tpu.options import DisplayOptions as JaxOptions  # noqa: E402
from timg_tpu.render import iterm2 as jiterm2  # noqa: E402
from timg_tpu.render import kitty as jkitty  # noqa: E402
from timg_tpu.render import plane_cache as jcache  # noqa: E402
from timg_tpu.render import png as jpng  # noqa: E402
from timg_tpu.render.sequencer import SeqType as JaxSeq  # noqa: E402
from timg_tpu_torch import models  # noqa: E402
from timg_tpu_torch.options import DisplayOptions  # noqa: E402
from timg_tpu_torch.render import iterm2 as titerm2  # noqa: E402
from timg_tpu_torch.render import kitty as tkitty  # noqa: E402
from timg_tpu_torch.render import plane_cache as tcache  # noqa: E402
from timg_tpu_torch.render import png as tpng  # noqa: E402
from timg_tpu_torch.render.sequencer import SeqType  # noqa: E402


def _rgba(seed, h, w, flat=False):
    rng = np.random.default_rng(seed)
    if flat:    # few colours: a PNG of a few hundred bytes
        f = np.zeros((h, w, 4), np.uint8)
        f[:, w // 2:, 0] = 200
        f[..., 3] = 255
        return f
    f = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    f[: h // 3, :, 3] = 0                      # a transparent region
    f[h // 3: h // 2, :, 3] = np.linspace(0, 255, w).astype(np.uint8)
    return f


# ------------------------------------------------------------------ png

@pytest.mark.parametrize("h,w,channels,with_alpha", [
    (1, 1, 4, True), (7, 13, 4, True), (7, 13, 4, False),
    (9, 5, 3, False), (16, 33, 4, False)])
def test_sub_filter_and_png_match_jax(h, w, channels, with_alpha):
    """Both packages' Sub filter (the native helper for 4 channels, numpy
    for 3) and whole PNG, RGB and RGBA, at odd sizes."""
    f = np.ascontiguousarray(_rgba(h * w, h, w)[..., :channels])
    assert tpng.sub_filter_rows(f, with_alpha) == \
        jpng.sub_filter_rows(f, with_alpha)
    for level in (1, 6):
        assert tpng.encode_png(f, level, with_alpha) == \
            jpng.encode_png(f, level, with_alpha)


def test_sub_filter_native_equals_numpy(monkeypatch):
    """The native filter and the numpy fallback write the same rows; the
    RGB first pixel is the reference's quirk (plain RGB, alpha dropped)."""
    from timg_tpu_torch.native import runtime

    f = _rgba(5, 6, 11)
    native = [tpng.sub_filter_rows(f, a) for a in (True, False)]
    monkeypatch.setattr(runtime, "load", lambda: None)
    fallback = [tpng.sub_filter_rows(f, a) for a in (True, False)]
    assert native == fallback
    row = fallback[1][:1 + 11 * 3]
    assert row[0] == 1 and row[1:4] == bytes(f[0, 0, :3])


# ------------------------------------------------------------ canvases

class _Sink:
    """Collects what a canvas hands the sequencer (futures resolved)."""

    def __init__(self):
        self.data = []

    def write_buffer(self, buf, seq_type, end_ms):
        self.data.append(buf.result() if isinstance(buf, Future) else buf)

    def bytes(self):
        return b"".join(self.data)


def _opts(cls, cell=(8, 16), local_alpha=True, level=1):
    opts = cls()
    opts.cell_x_px, opts.cell_y_px = cell
    opts.local_alpha_handling = local_alpha
    opts.compress_pixel_level = level
    return opts


def _pin(monkeypatch):
    for mod in (jkitty, tkitty):
        monkeypatch.setattr(mod, "_id_start", 400000)
        monkeypatch.setattr(mod, "_id_counter", 0)


_SENDS = {
    # one image, one chunk
    "one-chunk": [(0, 0, ("flat", 32, 48), "FRAME_IMMEDIATE")],
    # noise: a PNG over 3072 bytes, several 4096-character chunks
    "chunks": [(16, 0, ("noise", 40, 64), "FRAME_IMMEDIATE")],
    # an animation: two flip-flop ids, cursor moves up between frames
    "animation": [(0, 0, ("noise", 20, 24), "START_OF_ANIMATION"),
                  (0, -20, ("flat", 20, 24), "ANIMATION_FRAME"),
                  (0, -20, ("noise", 20, 24), "ANIMATION_FRAME"),
                  (0, -20, ("flat", 20, 24), "ANIMATION_FRAME")],
}


def _send_all(canvas, sends, seq):
    for k, (x, dy, (kind, h, w), seq_type) in enumerate(sends):
        canvas.send(x, dy, _rgba(k, h, w, flat=kind == "flat"),
                    getattr(seq, seq_type), 40.0 * (k + 1))


@pytest.mark.parametrize("local_alpha", [True, False])
@pytest.mark.parametrize("tmux", [False, True])
@pytest.mark.parametrize("sends", list(_SENDS))
def test_kitty_canvas_matches_jax(monkeypatch, sends, tmux, local_alpha):
    """Kitty payloads with ids pinned in both packages: one chunk,
    several chunks, an animation's flip-flop ids; with tmux passthrough
    each chunk is wrapped and the unicode-placeholder tiles follow."""
    _pin(monkeypatch)
    monkeypatch.delenv("TMUX", raising=False)
    out = []
    for mod, cls, seq in ((jkitty, JaxOptions, JaxSeq),
                          (tkitty, DisplayOptions, SeqType)):
        sink = _Sink()
        with ThreadPoolExecutor(max_workers=3) as pool:
            canvas = mod.KittyCanvas(sink, tmux, _opts(cls, local_alpha=
                                                       local_alpha),
                                     executor=pool)
            _send_all(canvas, _SENDS[sends], seq)
        out.append(sink.bytes())
    want, got = out
    assert got == want
    if sends == "chunks":
        assert got.count(b"Gq=2,m=") >= 2
    if sends == "animation":
        assert b"i=400001," in got and b"i=400002," in got
    if tmux:
        assert b"\033Ptmux;" in got and "\U0010EEEE".encode() in got


@pytest.mark.parametrize("sends", list(_SENDS))
def test_iterm2_canvas_matches_jax(sends):
    out = []
    for mod, cls, seq in ((jiterm2, JaxOptions, JaxSeq),
                          (titerm2, DisplayOptions, SeqType)):
        sink = _Sink()
        canvas = mod.ITerm2Canvas(sink, _opts(cls, local_alpha=False))
        _send_all(canvas, _SENDS[sends], seq)
        out.append(sink.bytes())
    assert out[1] == out[0]
    assert out[1].count(b"\033]1337;File=size=") == len(_SENDS[sends])


# --------------------------------------------------------------- models

@pytest.mark.parametrize("bg", [(0, 0, 0, 255), None])
@pytest.mark.parametrize("name", ["kitty", "iterm2"])
def test_pixel_model_matches_jax_model(name, bg):
    """models.get("kitty"/"iterm2").render_batch on seeded RGBA with a
    transparent region: resize and compose on the device, PNG on the
    host; numpy frames and a tensor alike."""
    frames = np.stack([_rgba(40 + i, 40, 60) for i in range(3)])
    kw = dict(out_h=21, out_w=34, bg_color=bg, compress_level=1)
    want = jmodels.get(name)(**kw).render_batch(frames)
    model = models.get(name)(**kw)
    assert model.render_batch(frames) == want
    assert model.render_batch(torch.from_numpy(frames)) == want
    assert len(want) == 3


# --------------------------------------------------------- video window

def _planes(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, h, w), dtype=np.uint8),
            rng.integers(0, 256, (b, (h + 1) // 2, (w + 1) // 2),
                         dtype=np.uint8),
            rng.integers(0, 256, (b, (h + 1) // 2, (w + 1) // 2),
                         dtype=np.uint8))


@pytest.fixture
def jax_device_window(monkeypatch):
    monkeypatch.setenv("TIMG_TPU_FORCE_DEVICE", "1")
    monkeypatch.delenv("TIMG_TPU_VIDEO_DEVICE_WINDOW", raising=False)


@pytest.mark.parametrize("resample", ["lean", "sws"])
@pytest.mark.parametrize("h,w,th,tw,full_range", [
    (48, 64, 30, 40, False),      # downscale
    (24, 32, 37, 51, True),       # upscale, odd width (sws: full chroma)
    (36, 50, 36, 50, False),      # equal size (sws: unscaled converter)
])
def test_prime_pixel_video_matches_jax(jax_device_window, resample, h, w,
                                       th, tw, full_range):
    """The pixel window, lean (convert + resize) and sws, frame by frame
    against the JAX package's window: placeholders of the window's
    shape whose pixels equal the JAX frames'."""
    ys, us, vs = _planes(h * w + tw, 3, h, w)
    jopts, topts = _opts(JaxOptions), _opts(DisplayOptions)
    want = jcache.prime_pixel_video_device(ys, us, vs, th, tw, full_range,
                                           jopts, resample=resample)
    got = tcache.prime_pixel_video_device(ys, us, vs, th, tw, full_range,
                                          topts, {}, resample=resample)
    assert len(got) == len(want) == 3
    for g, j in zip(got, want):
        assert isinstance(g, tcache.DeviceFrame)
        assert g.shape == j.shape == (th, tw, 4)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(j))
        assert tpng.encode_png(g, 1, True) == jpng.encode_png(j, 1, True)


def test_prime_pixel_video_declines_like_jax(jax_device_window,
                                             monkeypatch):
    """None for sixel and block sessions and with
    TIMG_TPU_VIDEO_DEVICE_WINDOW=0, as the JAX package."""
    ys, us, vs = _planes(3, 1, 12, 16)
    sixel, block = _opts(DisplayOptions), _opts(DisplayOptions, cell=(2, 2))
    sixel.sixel_batch_dither = "cube"
    for opts in (sixel, block):
        assert tcache.prime_pixel_video_device(ys, us, vs, 6, 8, False,
                                               opts, {}) is None
    monkeypatch.setenv("TIMG_TPU_VIDEO_DEVICE_WINDOW", "0")
    assert tcache.prime_pixel_video_device(
        ys, us, vs, 6, 8, False, _opts(DisplayOptions), {}) is None
    assert jcache.prime_pixel_video_device(
        ys, us, vs, 6, 8, False, _opts(JaxOptions)) is None


def test_pixel_window_frames_fetch_in_the_pool(jax_device_window):
    """The kitty canvas encodes a window's placeholders in its pool: the
    stream equals the JAX canvas's on the JAX window, and no frame is
    fetched before the canvas encodes it."""
    ys, us, vs = _planes(8, 4, 40, 56)
    out = []
    for mod, cache, cls, seq, kw in (
            (jkitty, jcache, JaxOptions, JaxSeq, {}),
            (tkitty, tcache, DisplayOptions, SeqType, {"state": {}})):
        mod._id_start, mod._id_counter = 400000, 0
        opts = _opts(cls)
        frames = cache.prime_pixel_video_device(ys, us, vs, 20, 28, False,
                                                opts, **kw)
        if cache is tcache:
            assert all(f._cache is None for f in frames)
        sink = _Sink()
        with ThreadPoolExecutor(max_workers=5) as pool:
            canvas = mod.KittyCanvas(sink, False, opts, executor=pool)
            for k, f in enumerate(frames):
                canvas.send(0, -20 if k else 0, f,
                            seq.START_OF_ANIMATION if k == 0
                            else seq.ANIMATION_FRAME, 40.0 * (k + 1))
        out.append(sink.bytes())
    assert out[1] == out[0]
    assert out[1].count(b"\033_Ga=T") == 4
