"""The port's CLI on stills against the JAX package's CLI.

Each case runs the JAX CLI (JAX_PLATFORMS=cpu, so its numpy mirrors)
and the port's (TIMG_TPU_TORCH_DEVICE=cpu, the plain versions of the
kernels) on the same file and flags under the scripted pty of
tests/test_torch_cli.py; the streams must be byte-identical.  The
inputs are tests/corpus.py's seeded corpus and a few files made here
from a seed: a QOI, a two-image ICO of different sizes, an 800x600 JPEG
that takes the draft decode, an APNG, and stills 61 and 1 px wide.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

from tests.corpus import build_corpus  # noqa: E402
from tests.test_torch_cli import _run_pty  # noqa: E402


def _qoi(path, rgba):
    """A QOI file of QOI_OP_RGBA chunks and runs (qoiformat.org)."""
    h, w = rgba.shape[:2]
    out = bytearray(b"qoif" + w.to_bytes(4, "big") + h.to_bytes(4, "big")
                    + bytes([4, 0]))
    px = rgba.reshape(-1, 4)
    i = 0
    while i < len(px):
        run = 1
        while (i + run < len(px) and run < 62 and i > 0
               and (px[i + run] == px[i - 1]).all()
               and (px[i] == px[i - 1]).all()):
            run += 1
        if i > 0 and (px[i] == px[i - 1]).all():
            out.append(0xC0 | (run - 1))
            i += run
            continue
        out += bytes([0xFF, *px[i]])
        i += 1
    out += bytes(7) + b"\x01"
    path.write_bytes(bytes(out))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("stills")
    out = build_corpus(str(d))
    rng = np.random.default_rng(2024)
    rgba = rng.integers(0, 256, (19, 27, 4), dtype=np.uint8)
    rgba[:6, :, 3] = 0
    rgba[6:9] = rgba[6]                          # runs for the encoder
    _qoi(d / "seeded_27x19.qoi", rgba)
    out["seeded_27x19.qoi"] = str(d / "seeded_27x19.qoi")
    ico = Image.fromarray(rng.integers(0, 256, (48, 48, 4), dtype=np.uint8),
                          "RGBA")
    ico.save(d / "two.ico", sizes=[(16, 16), (48, 48)])
    out["two.ico"] = str(d / "two.ico")
    yy, xx = np.mgrid[0:600, 0:800]
    photo = np.stack([xx * 255 // 800, yy * 255 // 600,
                      (xx ^ yy) & 255], -1).astype(np.uint8)
    Image.fromarray(photo).save(d / "photo_800x600.jpg", quality=90)
    out["photo_800x600.jpg"] = str(d / "photo_800x600.jpg")
    frames = [Image.fromarray(rng.integers(0, 256, (20, 30, 4),
                                           dtype=np.uint8), "RGBA")
              for _ in range(3)]
    frames[0].save(d / "anim.png", save_all=True, append_images=frames[1:],
                   duration=100, loop=0)
    out["anim.png"] = str(d / "anim.png")
    for w in (61, 1):           # few colours: every transport takes them
        stripes = np.zeros((23, w, 3), np.uint8)
        stripes[:, :, 0] = (np.arange(23) // 4 * 40)[:, None]
        stripes[:, : w // 2, 2] = 200
        Image.fromarray(stripes).save(d / f"stripes_{w}x23.png")
        out[f"stripes_{w}x23.png"] = str(d / f"stripes_{w}x23.png")
    return out


def _compare(tmp_path, files, argv, env=None, monkeypatch=None):
    from timg_tpu.cli import main as jax_main
    from timg_tpu_torch.cli import main as torch_main

    argv = ["--debug-no-frame-delay"] + [files.get(a, a) for a in argv]
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    want = _run_pty(jax_main, argv, tmp_path / "jax.out")
    got = _run_pty(torch_main, argv, tmp_path / "torch.out")
    assert got == want
    assert len(got) > 100
    return got


_SIXEL = ["-g20x10", "-ps"]
_MODES = {"pq": ["-g40x20", "-pq"], "ph": ["-g40x20", "-ph"],
          "cube": _SIXEL + ["--dither=cube"],
          "adaptive": _SIXEL + ["--dither=adaptive"],
          "libsixel": _SIXEL + ["--dither=libsixel"]}
_STILLS = {"noise": ["-b", "black", "noise_33x27.png"],
           "alpha-none": ["-b", "none", "alpha_80x100.png"],
           "alpha-black": ["-b", "black", "alpha_80x100.png"],
           "alpha-checker": ["-b", "white", "-B", "#808080",
                             "alpha_band_60x40.png"],
           "gradient": ["-b", "black", "gradient_320x200.png"]}


@pytest.mark.parametrize("still", list(_STILLS))
@pytest.mark.parametrize("mode", list(_MODES))
def test_still_stream_matches_jax(tmp_path, files, mode, still):
    _compare(tmp_path, files, _MODES[mode] + _STILLS[still])


@pytest.mark.parametrize("flags", [
    pytest.param(["-g20x10", "-ps", "--dither=libsixel"], id="libsixel"),
    pytest.param(["-g20x10", "-ps", "--dither=cube"], id="cube"),
    pytest.param(["-g40x20", "-pq"], id="pq")])
def test_animation_stream_matches_jax(tmp_path, files, flags):
    got = _compare(tmp_path, files, flags + ["--loops=1", "-b", "black",
                                             "anim_32x24.gif"])
    if "-ps" in flags:
        assert got.count(b"\033Pq") == 4


@pytest.mark.parametrize("flags,env", [
    pytest.param(["-g20x10", "-ps", "--dither=cube", "-b", "black"], {},
                 id="cube"),
    pytest.param(["-g40x20", "-pq", "-b", "black", "--title"], {},
                 id="pq-title"),
    pytest.param(["-g20x10", "-ps", "--dither=adaptive", "-b", "none",
                  "--title=%b %wx%h"], {}, id="adaptive-title"),
    pytest.param(["-g40x20", "-ph", "-b", "black"],
                 {"TIMG_TPU_NO_GRID_BATCH": "1"}, id="ph-no-batch")])
def test_grid_stream_matches_jax(tmp_path, files, monkeypatch, flags, env):
    """--grid 2x2 over four images: two share a geometry group (the
    collector's one dispatch), and without the collector."""
    _compare(tmp_path, files, flags + [
        "--grid=2x2", "noise_64x48.png", "alpha_80x100.png",
        "noise_64x48.png", "tiny_8x6.png"], env, monkeypatch)


@pytest.mark.parametrize("flags", [
    pytest.param(["-g40x20", "-pq", "-b", "black", "--auto-crop",
                  "bordered_90x60.png"], id="auto-crop"),
    pytest.param(["-g20x10", "-ps", "--dither=cube", "-b", "black",
                  "--auto-crop=2", "bordered_90x60.png"],
                 id="auto-crop-border"),
    pytest.param(["-g40x20", "-ph", "-b", "black", "-a",
                  "noise_512x512.png"], id="nearest"),
    pytest.param(["-g20x10", "-ps", "--dither=cube", "-b", "black", "-a",
                  "noise_512x512.png"], id="nearest-sixel"),
    pytest.param(["-g40x20", "-pq", "-b", "black", "-U", "tiny_8x6.png"],
                 id="upscale"),
    pytest.param(["-g40x20", "-ph", "-b", "black", "-W", "tiny_8x6.png"],
                 id="fit-width"),
    pytest.param(["-g40x20", "-pq", "-b", "black", "--frames=2",
                  "--loops=1", "anim_32x24.gif"], id="frames"),
    pytest.param(["-g40x20", "-pq", "-b", "black", "seeded_27x19.qoi"],
                 id="qoi"),
    pytest.param(["-g20x10", "-ps", "--dither=libsixel", "-b", "black",
                  "seeded_27x19.qoi"], id="qoi-libsixel"),
    pytest.param(["-g40x20", "-pq", "-b", "black", "two.ico"], id="ico"),
    pytest.param(["-g20x10", "-ps", "--dither=cube", "-b", "black",
                  "two.ico"], id="ico-sixel"),
    pytest.param(["-g40x20", "-pq", "-b", "black", "photo_800x600.jpg"],
                 id="jpeg-draft"),
    pytest.param(["-g20x10", "-ps", "-b", "black", "photo_800x600.jpg"],
                 id="jpeg-draft-libsixel"),
    pytest.param(["-g40x20", "-pq", "-b", "black", "gray16_48x32.png",
                  "alpha_40x30.bmp", "gray_50x40.png"], id="bit-depths")])
def test_still_options_match_jax(tmp_path, files, flags):
    _compare(tmp_path, files, flags)


@pytest.mark.parametrize("flags", [
    pytest.param(["-g20x10", "-ps", "--dither=libsixel"], id="libsixel"),
    pytest.param(["-g20x10", "-ps", "--dither=adaptive"], id="adaptive"),
    pytest.param(["-g40x20", "-pq"], id="pq")])
def test_scroll_stream_matches_jax(tmp_path, files, flags):
    """--scroll for a limited time (--debug-no-frame-delay keeps the
    frame clock synthetic, so -t bounds the frame count): more than one
    16-step window."""
    got = _compare(tmp_path, files, flags + [
        "-b", "black", "--scroll=20", "--delta-move=3:1", "-t0.7",
        "gradient_320x200.png"])
    if "-ps" in flags:
        assert got.count(b"\033Pq") >= 20


@pytest.mark.parametrize("transport", ["plane", "runs", "dcs"])
@pytest.mark.parametrize("still", ["stripes_61x23.png", "stripes_1x23.png"])
def test_transports_carry_odd_widths(tmp_path, files, monkeypatch,
                                     transport, still):
    """Each forced transport carries a still of odd width (61 px) and one
    1 px wide, whose height pads from 23 to 24 rows, in cube and adaptive
    mode."""
    from timg_tpu_torch.ops.sixel_runs import STATS

    monkeypatch.setenv("TIMG_TPU_SIXEL_TRANSPORT", transport)
    for dither in ("cube", "adaptive"):
        before = STATS[f"frames_{transport}"]
        _compare(tmp_path, files, ["-g20x10", "-ps", f"--dither={dither}",
                                   "-b", "black", still])
        assert STATS[f"frames_{transport}"] == before + 1


def test_apng_without_a_video_decoder_is_a_still(tmp_path, files,
                                                 monkeypatch):
    """Where no video decoder builds (the card's host has no libav), an
    APNG shows through Pillow in both packages; the JAX package asks its
    one native library, the port its video library alone."""
    from timg_tpu.native import runtime as jrt
    from timg_tpu_torch.native import runtime as trt

    monkeypatch.setattr(jrt, "load", lambda: None)
    monkeypatch.setattr(trt, "load_video", lambda: None)
    _compare(tmp_path, files, ["-g40x20", "-pq", "-b", "black", "--loops=1",
                               "anim.png"])


def test_unported_decoder_is_named(tmp_path):
    """An SVG, refused by name until the port had its decoders, now
    writes the JAX CLI's stream (librsvg and cairo through ctypes; every
    decoder: tests/test_torch_decoders.py)."""
    from timg_tpu_torch.sources.svg_source import _load

    if _load() is None:
        pytest.skip("librsvg/cairo unavailable")
    svg = tmp_path / "x.svg"
    svg.write_text('<svg xmlns="http://www.w3.org/2000/svg" width="40" '
                   'height="30"><rect width="40" height="30" '
                   'fill="#336699"/><circle cx="20" cy="15" r="9" '
                   'fill="#ffcc00" fill-opacity="0.5"/></svg>')
    files = {"x.svg": str(svg)}
    _compare(tmp_path, files, ["-g40x20", "-pq", "-b", "black", "x.svg"])
