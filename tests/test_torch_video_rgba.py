"""The port's RGBA and scaled video windows, and the streams of the inputs
that take them, against the JAX package on the CPU.

Window tests: ``VideoSource._process_window`` of the port (plain versions
of the kernels on the CPU) against the JAX package's, the JAX side under
TIMG_TPU_FORCE_DEVICE=1 with the plane transport, except the stb resize
of transparent-capable files, whose XLA:CPU form contracts FMAs: that
kind runs the JAX package's numpy mirrors, as its CLI does on the CPU.
Tolerance: byte equality of the returned frames and of every primed
block and sixel plane (cube, libsixel, adaptive, quarter, half).

CLI tests: the port's CLI against the JAX CLI (JAX_PLATFORMS=cpu) under
the scripted pty of tests/test_torch_cli.py on an APNG, a GIF through
the video source (``-V``), a 4:4:4 y4m, a 4:2:0 y4m under
TIMG_TPU_VIDEO_RGBA=1, ``--resample=sws`` and ``--resample=sws-bitexact``
on the 4:4:4 clip; the streams must be byte-identical.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

from timg_tpu.options import DisplayOptions as JOptions  # noqa: E402
from timg_tpu.render import plane_cache as jcache  # noqa: E402
from timg_tpu.sources.video_source import VideoSource as JVideo  # noqa: E402
from timg_tpu_torch.options import DisplayOptions as TOptions  # noqa: E402
from timg_tpu_torch.render import plane_cache as tcache  # noqa: E402
from timg_tpu_torch.sources.video_source import \
    VideoSource as TVideo  # noqa: E402

from tests.test_torch_cli import _run_pty, _y4m, native  # noqa: E402,F401
from tests.test_torch_pixel_cli import _pin_ids  # noqa: E402

# mode -> (cell_x_px, cell_y_px, sixel_batch_dither)
MODES = {"cube": (8, 16, "cube"), "libsixel": (8, 16, "libsixel"),
         "adaptive": (8, 16, "adaptive"), "quarter": (2, 2, None),
         "half": (1, 2, None)}
H, W, TH, TW = 36, 48, 30, 40      # stream and display size


def _frames(seed, b, h=H, w=W, alpha=False):
    """Seeded RGBA frames as the helper's swscale hands them over:
    gradients and noise, opaque; with ``alpha``, a fully transparent
    band and an alpha ramp."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((b, h, w, 4), np.uint8)
    for i in range(b):
        for c in range(3):
            out[i, ..., c] = (xx * (50 + 40 * c) // w + yy * 90 // h
                              + 23 * i + rng.integers(0, 30, (h, w))) % 256
        out[i, ..., 3] = 255
        if alpha:
            out[i, :, : w // 4, 3] = 0
            out[i, h // 2:, w // 4:, 3] = np.linspace(
                250, 1, w - w // 4).astype(np.uint8)
    return out


def _yuv(seed, b, h=H, w=W):
    rng = np.random.default_rng(seed)
    return [(rng.integers(16, 236, (h, w), dtype=np.uint8),
             rng.integers(16, 240, ((h + 1) // 2, (w + 1) // 2),
                          dtype=np.uint8),
             rng.integers(16, 240, ((h + 1) // 2, (w + 1) // 2),
                          dtype=np.uint8)) for _ in range(b)]


def _source(cls, options, mode, suffix, bg, calls):
    opts = options()
    cell_x, cell_y, dither = MODES[mode]
    opts.cell_x_px, opts.cell_y_px = cell_x, cell_y
    opts.sixel_batch_dither = dither
    opts.width, opts.height = TW, TH
    opts.bg_pattern_color = (90, 90, 90, 255)   # a checkerboard
    opts.pattern_size = 2

    def getter():
        calls.append(1)
        return bg
    opts.bgcolor_getter = getter
    src = cls("clip" + suffix)
    src._options = opts
    src._target = (TW, TH)
    src._transparent_suffix = suffix in (".png", ".gif")
    return src


@pytest.fixture
def jax_device_window(monkeypatch):
    """The JAX package's device window on the CPU, plane transport."""
    monkeypatch.setenv("TIMG_TPU_FORCE_DEVICE", "1")
    monkeypatch.setenv("TIMG_TPU_SIXEL_TRANSPORT", "plane")
    monkeypatch.delenv("TIMG_TPU_VIDEO_DEVICE_WINDOW", raising=False)


def _pop_equal(got, want, mode):
    """Frames, and each frame's primed block or sixel entry, equal."""
    assert len(got) == len(want)
    prev_t = None
    for i, (g, j) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(j))
        if MODES[mode][2] is not None:
            gp, gpal, gq = tcache.SIXEL_PLANES.pop(g)
            jp, jpal, jq = jcache.SIXEL_PLANES.pop(j)
            np.testing.assert_array_equal(gp, np.asarray(jp))
            assert (gpal is None) == (jpal is None)
            if gpal is not None:
                np.testing.assert_array_equal(gpal, jpal)
            assert (gq is None) == (jq is None)
            if gq is not None:
                for a, b in zip(gq, jq):
                    np.testing.assert_array_equal(a, np.asarray(b))
            continue
        tp = tcache.BLOCK_PLANES.pop(g)
        jp = jcache.BLOCK_PLANES.pop(j)
        np.testing.assert_array_equal(np.asarray(tp[0]), jp[0])
        for k in (1, 2, 3):              # glyph, fg, bg
            np.testing.assert_array_equal(tp[k], np.asarray(jp[k]))
        # frame 0's previous frame: none in an RGBA window, the tail of
        # the last 4:2:0 window in a 4:2:0 one
        assert (tp[4] is None) == (jp[4] is None)
        if i:
            assert tp[4] is prev_t       # the canvas's identity check
        if tp[4] is not None:
            np.testing.assert_array_equal(np.asarray(tp[4]),
                                          np.asarray(jp[4]))
            np.testing.assert_array_equal(tp[5], np.asarray(jp[5]))
        prev_t = tp[0]


# kind -> (the file's suffix, the window kind, frames at the display size)
KINDS = {"transparent": (".png", "rgba", False),
         "opaque": (".mkv", "rgba", False),
         "scaled": (".mkv", "scaled", True)}


@pytest.mark.parametrize("alpha", [False, True], ids=["solid", "alpha"])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("mode", list(MODES))
def test_window_matches_jax(jax_device_window, monkeypatch, mode, kind,
                            alpha):
    """Two windows of each kind in each mode, on opaque frames and on
    frames with a transparent band and an alpha ramp (bg black, a grey
    checkerboard): frames and planes equal.  The background is asked
    for only where a pixel is transparent after the resize."""
    suffix, window, scaled = KINDS[kind]
    if kind == "transparent":
        monkeypatch.delenv("TIMG_TPU_FORCE_DEVICE")    # stb on numpy
    calls_t, calls_j = [], []
    tsrc = _source(TVideo, TOptions, mode, suffix, (0, 0, 0, 255), calls_t)
    jsrc = _source(JVideo, JOptions, mode, suffix, (0, 0, 0, 255), calls_j)
    for k in range(2):
        raw = _frames(10 * k + len(mode), 3, *((TH, TW) if scaled else
                                               (H, W)), alpha=alpha)
        got = tsrc._process_window(list(raw.copy()), window)
        want = jsrc._process_window(list(raw.copy()), window)
        _pop_equal(got, want, mode)
    # the lean resize of an opaque codec writes alpha 255
    assert len(calls_t) == (2 if alpha and kind != "opaque" else 0)
    assert len(calls_j) >= len(calls_t)


@pytest.mark.parametrize("bg", [(0, 0, 0, 0), (200, 30, 60, 255)],
                         ids=["none", "opaque"])
@pytest.mark.parametrize("mode", ["cube", "quarter"])
def test_transparent_window_host_order_matches_jax(monkeypatch, mode, bg):
    """The port's RGBA window writes the JAX window's bytes, with and
    without a background to compose against, whether or not
    TIMG_TPU_VIDEO_DEVICE_WINDOW=0 (the JAX package's host order) is
    set: the port ignores that setting here."""
    calls = []
    jsrc = _source(JVideo, JOptions, mode, ".gif", bg, calls)
    raw = _frames(5, 4, alpha=True)
    want = jsrc._process_window(list(raw.copy()), "rgba")
    for env in ("1", "0"):
        monkeypatch.setenv("TIMG_TPU_VIDEO_DEVICE_WINDOW", env)
        tsrc = _source(TVideo, TOptions, mode, ".gif", bg, calls)
        got = tsrc._process_window(list(raw.copy()), "rgba")
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g, j)
        for g in got:
            cache = tcache.SIXEL_PLANES if mode == "cube" \
                else tcache.BLOCK_PLANES
            assert cache.pop(g) is not None


def test_opaque_window_resizes_words_with_k1(monkeypatch):
    """The opaque RGBA window hands the frames to resize_video_words as
    int32 words, a view of the uploaded bytes (R in the low byte, as the
    K1 kernel reads them): its output equals the plain version on the
    same words, alpha 255."""
    from timg_tpu_torch.ops import resize as rz
    from timg_tpu_torch.sources import video_source as vs

    seen = []

    def spy(words, out_h, out_w):
        seen.append(words.clone())
        return rz.resize_video_words(words, out_h, out_w)

    monkeypatch.setattr(vs, "resize_video_words", spy)
    calls = []
    src = _source(TVideo, TOptions, "half", ".mkv", (0, 0, 0, 255), calls)
    raw = _frames(3, 2)
    got = src._process_window(list(raw.copy()), "rgba")
    assert len(seen) == 1 and seen[0].dtype == torch.int32
    np.testing.assert_array_equal(seen[0].numpy(),
                                  raw.view(np.int32)[..., 0])
    want = rz.resize_video_words_plain(torch.from_numpy(
        raw.view(np.int32)[..., 0].copy()), TH, TW).numpy()
    np.testing.assert_array_equal(np.stack(got).view(np.int32)[..., 0],
                                  want)
    assert all((np.asarray(f)[..., 3] == 255).all() for f in got)
    assert calls == []
    for g in got:
        tcache.BLOCK_PLANES.pop(g)


@pytest.mark.parametrize("mode", list(MODES))
def test_kind_switch_mid_stream_matches_jax(jax_device_window, mode):
    """A 4:2:0 window, then a window of frames the helper returned as
    RGBA (``ret == 2``), then 4:2:0 again, as send_frames flushes them:
    the stage, the adaptive tree and the block tail carried across the
    switch as the JAX package carries them."""
    calls_t, calls_j = [], []
    tsrc = _source(TVideo, TOptions, mode, ".mkv", (0, 0, 0, 255), calls_t)
    jsrc = _source(JVideo, JOptions, mode, ".mkv", (0, 0, 0, 255), calls_j)
    for src in (tsrc, jsrc):
        src._use_yuv, src._full_range = True, False
    for k, window in enumerate(("yuv", "rgba", "yuv")):
        if window == "yuv":
            raw = _yuv(k + 40, 3)
        else:
            raw = list(_frames(k + 40, 2))
        got = tsrc._process_window(list(raw), window)
        want = jsrc._process_window(list(raw), window)
        _pop_equal(got, want, mode)
    if mode == "adaptive":
        for a, b in zip(tsrc._sixel_state["quantizer"],
                        jsrc._sixel_state["quantizer"]):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_sws_scale_rgba_binding_matches_jax():
    """The port binds the helper's standalone RGBA swscale as the JAX
    package does (ref image-scaler.cc:45-73)."""
    from timg_tpu.native import runtime as jrt
    from timg_tpu_torch.native import runtime as trt

    lib = trt.load_video()
    if lib is None or jrt.load() is None:
        pytest.skip("native video helper unavailable")
    rgba = np.ascontiguousarray(_frames(8, 1)[0])
    for bitexact in (0, 1):
        out = np.empty((TH, TW, 4), np.uint8)
        assert lib.timg_sws_scale_rgba(rgba.ctypes.data, W, H, TW, TH,
                                       bitexact, out.ctypes.data) == 0
        np.testing.assert_array_equal(
            out, jrt.sws_scale_rgba(rgba, TH, TW, bool(bitexact)))


# ---------------------------------------------------------------- CLI


def _apng(path, w=W, h=H, n=4):
    """Animated PNG with real transparency (tests/test_video_device_window
    .py's ``_apng``)."""
    from PIL import Image

    rng = np.random.default_rng(21)
    frames = []
    for i in range(n):
        a = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        a[:, : w // 3, 3] = 0          # fully transparent stripe
        a[h // 3:, :, 3] = 255         # opaque lower block
        frames.append(Image.fromarray(a, "RGBA"))
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=40, loop=0)
    return str(path)


def _gif(path, w=W, h=H, n=4):
    from PIL import Image

    rgb = _frames(77, n, h, w)[..., :3]
    frames = [Image.fromarray(f) for f in rgb]
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=40, loop=0)
    return str(path)


def _y4m444(path, w=W, h=H, n=5):
    """A 4:4:4 clip: libav decodes it as yuv444p, which the helper
    swscales to RGBA (the opaque RGBA window)."""
    rng = np.random.default_rng(31)
    yy, xx = np.mgrid[0:h, 0:w]
    with open(path, "wb") as f:
        f.write(("YUV4MPEG2 W%d H%d F25:1 Ip A1:1 C444\n"
                 % (w, h)).encode())
        for i in range(n):
            f.write(b"FRAME\n")
            f.write(np.clip(40 + xx * 3 + yy + 9 * i, 16, 235)
                    .astype(np.uint8).tobytes())
            f.write(rng.integers(90, 170, (h, w), dtype=np.uint8).tobytes())
            f.write(np.full((h, w), 140, np.uint8).tobytes())
    return str(path)


def _compare(tmp_path, argv):
    from timg_tpu.cli import main as jax_main
    from timg_tpu_torch.cli import main as torch_main

    argv = ["--debug-no-frame-delay", "-g40x20", "-b", "black",
            "--loops=1"] + argv
    _pin_ids()
    want = _run_pty(jax_main, argv, tmp_path / "jax.out")
    _pin_ids()
    got = _run_pty(torch_main, argv, tmp_path / "torch.out")
    assert got == want
    assert len(got) > 100
    return got


# input -> (file maker, extra flags, environment)
INPUTS = {
    "apng": (lambda d: _apng(d / "anim.png"), [], {}),
    "gif-video": (lambda d: _gif(d / "anim.gif"), ["-V"], {}),
    "c444": (lambda d: _y4m444(d / "c444.y4m"), [], {}),
    "rgba-env": (lambda d: _y4m(d), [], {"TIMG_TPU_VIDEO_RGBA": "1"}),
    "sws": (lambda d: _y4m(d), ["--resample=sws"], {}),
    "sws-bitexact-c444": (lambda d: _y4m444(d / "c444.y4m"),
                          ["--resample=sws-bitexact"], {}),
}
PROTOCOLS = {"pq": ["-pq"], "ph": ["-ph"],
             "cube": ["-ps", "--dither=cube"],
             "libsixel": ["-ps", "--dither=libsixel"], "pk": ["-pk"]}


@pytest.mark.parametrize("protocol", list(PROTOCOLS))
@pytest.mark.parametrize("name", list(INPUTS))
def test_cli_stream_matches_jax(native, tmp_path, monkeypatch, name,
                                protocol):
    make, flags, env = INPUTS[name]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    clip = make(tmp_path)
    got = _compare(tmp_path, PROTOCOLS[protocol] + flags + [clip])
    n = 5 if name in ("c444", "rgba-env", "sws", "sws-bitexact-c444") \
        else 4
    if protocol in ("cube", "libsixel"):
        assert got.count(b"\033Pq") == n
    elif protocol == "pk":
        assert got.count(b"\033_Ga=T") == n
