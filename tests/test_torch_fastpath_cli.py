"""The port's one-shot still fast path (timg_tpu_torch.fast) against the
JAX package's (timg_tpu.fast) and the port's CLI, on the CPU.

With TIMG_TPU_TORCH_DEVICE=cpu, every case of tests/test_fastpath_cli.py's
matrices must give the JAX fast path's (output bytes, stderr, exit code);
a subset must also give the port's CLI's (cli.main, the route the
launcher takes when the fast path bails).  Without the CPU asked the
port's fast path returns None at once and writes nothing.  Cases run in
this process (capsys), as the JAX suite runs them; the launcher itself
is run once as a subprocess, to show what it imports.

Tolerance: none -- byte equality.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests.corpus import build_corpus
from timg_tpu import fast as jax_fast
from timg_tpu_torch import fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--debug-no-frame-delay"]
KITTY_ID = 400000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return build_corpus(str(tmp_path_factory.mktemp("corpus")))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("TIMG_TPU_NO_FASTPATH", "TIMG_TPU_FORCE_NUMPY",
                "TIMG_TPU_FORCE_DEVICE", "TIMG_PIXELATION",
                "TIMG_USE_UPPER_BLOCK", "TIMG_DEFAULT_TITLE",
                "TIMG_FONT_WIDTH_CORRECT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TIMG_TPU_TORCH_DEVICE", "cpu")


def _kitty_ids():
    from timg_tpu_torch.render import kitty

    return ((fast, "_kitty_id_start", "_kitty_id_counter"),
            (jax_fast, "_kitty_id_start", "_kitty_id_counter"),
            (kitty, "_id_start", "_id_counter"))


@pytest.fixture(autouse=True)
def _pinned_kitty_ids(monkeypatch):
    """Kitty ids are clock-seeded: both fast paths' and the port's
    canvas's are pinned (and restored after the test)."""
    for mod, start, counter in _kitty_ids():
        monkeypatch.setattr(mod, start, KITTY_ID)
        monkeypatch.setattr(mod, counter, 0)


def _pin(start=KITTY_ID):
    for mod, start_name, counter in _kitty_ids():
        setattr(mod, start_name, start)
        setattr(mod, counter, 0)


def _read(path):
    if not os.path.exists(path):
        return b""
    with open(path, "rb") as f:
        return f.read()


def _triple(fn, argv, out, capsys, pin=KITTY_ID):
    _pin(pin)
    rc = fn(argv + ["-o", out])
    return rc, capsys.readouterr().err, _read(out)


def _run_both(argv, tmp_path, capsys, cli=False):
    """The port's fast path == the JAX fast path (and, with ``cli``, ==
    the port's CLI on the CPU): (exit code, stderr, bytes)."""
    port = _triple(fast.try_fast_main, argv, str(tmp_path / "port.out"),
                   capsys)
    assert port[0] is not None, f"unexpected bail for {argv}"
    ref = _triple(jax_fast.try_fast_main, argv, str(tmp_path / "jax.out"),
                  capsys)
    assert port == ref, argv
    if cli:
        from timg_tpu_torch.cli import main

        full = _triple(main, argv, str(tmp_path / "cli.out"), capsys)
        assert port == full, argv
    return port


MATRIX = [
    # (extra flags, corpus files, also against the port's CLI)
    (["-pq", "-g80x24", "-b", "black"], ["noise_512x512.png"], True),
    (["-ph", "-g80x24", "-b", "black"], ["noise_512x512.png"], True),
    (["-pq", "-g40x12", "-b", "none"], ["gradient_320x200.png"], True),
    (["-pq", "-g80x24", "-b", "black"], ["noise_33x27.png"], True),
    (["-ph", "-g80x24", "-b", "black"], ["noise_33x27.png"], False),
    (["-pq", "-g80x24", "-b", "#336699"], ["alpha_80x100.png"], True),
    (["-pq", "-g80x24", "-b", "gray", "-B", "white"],
     ["alpha_80x100.png"], True),
    (["-pq", "-g80x24", "-b", "white", "-B", "silver",
      "--pattern-size", "3"], ["alpha_band_60x40.png"], False),
    (["-pq", "-g80x24", "-b", "rgb(10, 20, 30)"], ["alpha_band_60x40.png"],
     False),
    (["-pq", "-g80x24", "-b", "black"], ["tiny_8x6.png"], False),
    (["-pq", "-g80x24", "-b", "black", "-U"], ["tiny_8x6.png"], True),
    (["-pq", "-g80x24", "-b", "black", "--upscale=i"], ["tiny_8x6.png"],
     False),
    (["-pq", "-g80x24", "-b", "black", "-U", "-U"], ["tiny_8x6.png"], False),
    (["-pq", "-g80x24", "-b", "black", "-W"], ["gray_50x40.png"], True),
    (["-pq", "-g80x24", "-b", "black", "-C"], ["noise_64x48.png"], False),
    (["-pq", "-g80x24", "-b", "black", "-a"], ["noise_512x512.png"], True),
    (["-pq", "-g80x24", "-b", "black", "--color8"],
     ["gradient_320x200.png"], True),
    (["-pq", "-g80x24", "-b", "black", "--title"], ["noise_64x48.png"],
     False),
    (["-pq", "-g80x24", "-b", "black", "--title=%b %wx%h %D", "-C"],
     ["noise_64x48.png"], True),
    (["-pq", "-g80x24", "-b", "black", "--clear"], ["noise_64x48.png"],
     False),
    (["-pq", "-g80x24", "-b", "black", "--clear=every"],
     ["noise_64x48.png", "gray_50x40.png"], True),
    (["-pq", "-g80x24", "-b", "black"],
     ["noise_64x48.png", "alpha_80x100.png", "tiny_8x6.png"], True),
    (["-pq", "-g80x24", "-b", "black", "-E"], ["noise_64x48.png"], False),
    (["-pq", "-g80x24", "-b", "black", "-t", "0"], ["noise_64x48.png"],
     True),
    (["-pq", "-g80x24", "-b", "black", "-t", "5"], ["noise_64x48.png"],
     False),
    (["-pq", "-g11x7", "-b", "black"], ["noise_512x512.png"], False),
    (["-ph", "-g200x60", "-b", "black", "-U"], ["gradient_320x200.png"],
     True),
    (["-pq", "-g80x24", "-b", "black", "--rotate", "off"],
     ["noise_64x48.png"], False),
    (["-pq", "-g80x24", "-b", "black", "--loops=3"], ["noise_64x48.png"],
     False),
]


@pytest.mark.parametrize("flags,files,cli", MATRIX,
                         ids=[" ".join(m[0]) + ":" + ",".join(m[1])
                              for m in MATRIX])
def test_fast_matches(corpus, flags, files, cli, tmp_path, capsys):
    _run_both(BASE + flags + [corpus[f] for f in files], tmp_path, capsys,
              cli=cli)


def test_fast_env_matrix(corpus, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("TIMG_USE_UPPER_BLOCK", "1")
    _run_both(BASE + ["-pq", "-g80x24", "-b", "black",
                      corpus["noise_33x27.png"]], tmp_path, capsys,
              cli=True)
    monkeypatch.delenv("TIMG_USE_UPPER_BLOCK")
    monkeypatch.setenv("TIMG_PIXELATION", "h")
    _run_both(BASE + ["-g80x24", "-b", "black", corpus["noise_64x48.png"]],
              tmp_path, capsys, cli=True)
    monkeypatch.delenv("TIMG_PIXELATION")
    monkeypatch.setenv("TIMG_DEFAULT_TITLE", "** %b **")
    _run_both(BASE + ["-pq", "-g80x24", "-b", "black", "--title",
                      corpus["noise_64x48.png"]], tmp_path, capsys)
    monkeypatch.delenv("TIMG_DEFAULT_TITLE")
    monkeypatch.setenv("TIMG_FONT_WIDTH_CORRECT", "0.75")
    _run_both(BASE + ["-pq", "-g80x24", "-b", "black",
                      corpus["noise_64x48.png"]], tmp_path, capsys)


def test_fast_missing_file_error(tmp_path, capsys):
    _run_both(BASE + ["-pq", "-g80x24", "-b", "black",
                      str(tmp_path / "nope.png")], tmp_path, capsys,
              cli=True)


def test_fast_missing_and_good_mix(corpus, tmp_path, capsys):
    _run_both(BASE + ["-pq", "-g80x24", "-b", "black",
                      str(tmp_path / "nope.png"), corpus["noise_64x48.png"]],
              tmp_path, capsys, cli=True)


def test_fast_directory_input(tmp_path, capsys):
    d = tmp_path / "adir.png"
    d.mkdir()
    _run_both(BASE + ["-pq", "-g80x24", "-b", "black", str(d)], tmp_path,
              capsys, cli=True)


def test_fast_filelist(corpus, tmp_path, capsys):
    fl = tmp_path / "list.txt"
    fl.write_text(corpus["noise_64x48.png"] + "\n"
                  + corpus["gray_50x40.png"] + "\n")
    _run_both(BASE + ["-pq", "-g80x24", "-b", "black", "-f", str(fl)],
              tmp_path, capsys, cli=True)
    _run_both(BASE + ["-pq", "-g80x24", "-b", "black", "-f",
                      str(tmp_path / "absent.lst")], tmp_path, capsys,
              cli=True)


def test_fast_geometry_error(corpus, tmp_path, capsys):
    # -g parses but is absurd -> "unusual size" + exit 3 on every path
    _run_both(["-pq", "-g0x0", "-b", "black", corpus["noise_64x48.png"]],
              tmp_path, capsys, cli=True)


def _expect_bail(argv):
    assert fast.try_fast_main(argv) is None, f"expected bail for {argv}"
    assert jax_fast.try_fast_main(argv) is None, argv


def test_fast_bails_outside_envelope(corpus, tmp_path, monkeypatch,
                                     capsys):
    img = corpus["noise_64x48.png"]
    base = ["-pq", "-g80x24", "-b", "black"]
    for extra in (["--grid=2", img, img], ["--verbose", img],
                  ["--scroll", img], ["--auto-crop", img],
                  ["--frames", "2", img], ["--frame-offset", "1", img],
                  ["-V", img], ["--version"], ["--help"],
                  [corpus["gray16_48x32.png"]], ["--upscale=x", img]):
        _expect_bail(base + extra)
    for argv in (["-ps", "--dither=cube", "-g80x24", img],
                 ["-ps", "--dither=adaptive", "-g80x24", img],
                 ["-p", "zebra", "-g80x24", img],
                 ["-pq", "-g80x24", "-b", "notacolor", img],
                 ["-pq", "-g80x24", "-B", "notacolor", img]):
        _expect_bail(argv)
    assert fast.try_fast_main(base + ["--devices", "2", img]) is None
    jpg = tmp_path / "x.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0" + b"0" * 64)
    _expect_bail(base + [str(jpg)])
    assert capsys.readouterr() == ("", "")
    monkeypatch.setenv("TIMG_TPU_NO_FASTPATH", "1")
    _expect_bail(base + [img])
    monkeypatch.delenv("TIMG_TPU_NO_FASTPATH")
    # the JAX force-backend variables mean nothing to the port: it
    # renders what the JAX fast path renders without them
    monkeypatch.setenv("TIMG_TPU_FORCE_NUMPY", "1")
    got = _triple(fast.try_fast_main, base + [img],
                  str(tmp_path / "forced.out"), capsys)
    monkeypatch.delenv("TIMG_TPU_FORCE_NUMPY")
    assert got == _triple(jax_fast.try_fast_main, base + [img],
                          str(tmp_path / "plain.out"), capsys)


@pytest.mark.parametrize("device", [None, "cuda", "", " CUDA ", "cpux"])
def test_fast_needs_the_cpu_asked(corpus, device, tmp_path, capsys,
                                  monkeypatch):
    """Without TIMG_TPU_TORCH_DEVICE=cpu the port's fast path returns
    None at once and writes nothing (not even the -o file); " cpu " is
    the CPU, as ops/backend.py reads it."""
    if device is None:
        monkeypatch.delenv("TIMG_TPU_TORCH_DEVICE")
    else:
        monkeypatch.setenv("TIMG_TPU_TORCH_DEVICE", device)
    out = tmp_path / "o.bin"
    assert fast.try_fast_main(["-pq", "-g80x24", "-b", "black", "-o",
                               str(out), corpus["noise_64x48.png"]]) is None
    assert not out.exists()
    assert capsys.readouterr() == ("", "")
    monkeypatch.setenv("TIMG_TPU_TORCH_DEVICE", " CPU ")
    assert fast.try_fast_main(["-pq", "-g80x24", "-b", "black", "-o",
                               str(out), corpus["noise_64x48.png"]]) == 0
    assert out.read_bytes()


def test_fast_bails_without_writing(corpus, tmp_path):
    """A bail leaves no partial output even with -o given."""
    out = tmp_path / "o.bin"
    assert fast.try_fast_main(["-pq", "-g80x24", "-b", "black", "-o",
                               str(out), corpus["gray16_48x32.png"]]) is None
    assert out.read_bytes() == b""


@pytest.mark.parametrize("argv", [
    ["-pq", "-gzzz", "-b", "black", "x.png"],
    ["-pq", "-g80x24", "--clear=bogus", "x.png"],
    ["-pq", "-g80x24", "--rotate=x", "x.png"],
    ["-pq", "-g80x24", "--bogus-flag", "x.png"],
])
def test_fast_parameter_error_codes(argv, capsys):
    got = (fast.try_fast_main(argv), capsys.readouterr().err)
    assert got == (jax_fast.try_fast_main(argv), capsys.readouterr().err)
    assert got[0] == 2


def test_launcher_imports_no_torch(corpus, tmp_path):
    """`python3 -S timg-tpu-torch` with the CPU asked renders a PNG on
    the fast path: -X importtime shows none of torch, numpy, jax or the
    JAX package, nor the port's CLI; the bytes are the CLI's."""
    img = corpus["alpha_80x100.png"]
    argv = ["-pq", "-g60x20", "--debug-no-frame-delay", "-b", "teal",
            "--title", "-C", img]
    env = {k: v for k, v in os.environ.items() if not k.startswith("TIMG_")}
    env["TIMG_TPU_TORCH_DEVICE"] = "cpu"
    launcher = os.path.join(REPO, "timg-tpu-torch")
    outs = []
    for extra, flags in (({}, ["-X", "importtime"]),
                         ({"TIMG_TPU_NO_FASTPATH": "1",
                           "TIMG_TPU_NO_SERVE": "1"}, [])):
        out = str(tmp_path / f"{len(outs)}.out")
        r = subprocess.run([sys.executable, "-S", *flags, launcher, *argv,
                            "-o", out], env=dict(env, **extra),
                           capture_output=True, stdin=subprocess.DEVNULL,
                           timeout=300)
        assert r.returncode == 0, r.stderr[-400:]
        outs.append((_read(out), r))
    modules = {line.rsplit("|", 1)[-1].strip()
               for line in outs[0][1].stderr.decode().splitlines()
               if line.startswith("import time:")}
    assert "timg_tpu_torch.fast" in modules
    assert not {m for m in modules
                if m.split(".")[0] in ("torch", "numpy", "jax", "jaxlib",
                                       "timg_tpu")
                or m == "timg_tpu_torch.cli"}, modules
    assert outs[0][0] == outs[1][0] and outs[0][0]
    assert outs[1][1].stderr == b""


# -------------------------------------------------------------------------
# PIL stills: JPEG/GIF/BMP/WebP decode through PIL, the pixel work in C
# -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pil_stills(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("pilstills")
    rng = np.random.default_rng(21)
    out = {}
    rgb = rng.integers(0, 256, (90, 130, 3), dtype=np.uint8)
    out["jpg"] = str(d / "photo.jpg")
    Image.fromarray(rgb).save(out["jpg"], quality=88)
    out["bigjpg"] = str(d / "big.jpg")      # the DCT-domain draft
    Image.fromarray(rng.integers(0, 256, (700, 900, 3), dtype=np.uint8)
                    ).save(out["bigjpg"], quality=85)
    img = Image.fromarray(rgb)
    exif = img.getexif()
    exif[0x0112] = 6
    out["exifjpg"] = str(d / "rot.jpg")
    img.save(out["exifjpg"], quality=88, exif=exif)
    out["gif"] = str(d / "still.gif")
    Image.fromarray(rgb).quantize(colors=60).save(out["gif"])
    out["bmp"] = str(d / "x.bmp")
    Image.fromarray(rgb).save(out["bmp"])
    out["webp"] = str(d / "x.webp")
    Image.fromarray(rgb).save(out["webp"], lossless=True)
    frames = [Image.fromarray(rng.integers(0, 256, (20, 24, 3),
                                           dtype=np.uint8)).quantize(32)
              for _ in range(3)]
    out["animgif"] = str(d / "anim.gif")
    frames[0].save(out["animgif"], save_all=True, append_images=frames[1:],
                   duration=50)
    return out


@pytest.mark.parametrize("key", ["jpg", "bigjpg", "exifjpg", "gif", "bmp",
                                 "webp"])
def test_fast_pil_stills(key, pil_stills, tmp_path, capsys):
    _run_both(BASE + ["-pq", "-g80x24", "-b", "black", pil_stills[key]],
              tmp_path, capsys, cli=key in ("jpg", "bigjpg", "gif"))


def test_fast_pil_still_rotate_off_and_mixed(corpus, pil_stills, tmp_path,
                                            capsys):
    _run_both(BASE + ["-pq", "-g80x24", "-b", "black", "--rotate", "off",
                      pil_stills["exifjpg"]], tmp_path, capsys)
    _run_both(BASE + ["-pq", "-g80x24", "-b", "black", "--title",
                      corpus["noise_64x48.png"], pil_stills["jpg"]],
              tmp_path, capsys, cli=True)


def test_fast_bails_on_animated_gif(pil_stills):
    _expect_bail(BASE + ["-pq", "-g80x24", "-b", "black",
                         pil_stills["animgif"]])


# -------------------------------------------------------------------------
# The pixel protocols: iTerm2 and kitty (PNG through png_core), sixel
# (libsixel's quantizer and the C assembler)
# -------------------------------------------------------------------------

ITERM_MATRIX = [
    (["-pi", "-g60x20", "-b", "black"], ["noise_64x48.png"]),
    (["-pi", "-g60x20", "-b", "auto"], ["alpha_80x100.png"]),   # -> none
    (["-pi", "-g60x20", "-b", "none"], ["alpha_80x100.png"]),
    (["-pi", "-g60x20", "-b", "#224466"], ["alpha_80x100.png"]),
    (["-pi", "-g60x20", "-b", "black", "--compress=6"],
     ["noise_512x512.png"]),
    (["-pi", "-g60x20", "-b", "black", "--compress=0"],
     ["noise_64x48.png"]),
    (["-pi", "-g60x20", "-b", "black", "--title", "-C"],
     ["gradient_320x200.png"]),
    (["-pi", "-g60x20", "-b", "black"],
     ["noise_64x48.png", "gray_50x40.png"]),
]

KITTY_MATRIX = [
    (["-pk", "-g60x20", "-b", "black"], ["noise_64x48.png"]),
    (["-pk", "-g60x20", "-b", "auto"], ["alpha_80x100.png"]),
    (["-pk", "-g60x20", "-b", "none"], ["alpha_80x100.png"]),
    (["-pk", "-g60x20", "-b", "#224466"], ["alpha_80x100.png"]),
    (["-pk", "-g60x20", "-b", "black", "--compress=6"],
     ["noise_512x512.png"]),                      # a multi-chunk APC
    (["-pk", "-g60x20", "-b", "black", "--title", "-C"],
     ["gradient_320x200.png"]),
    (["-pk", "-g60x20", "-b", "black"],
     ["noise_64x48.png", "gray_50x40.png"]),
]

SIXEL_MATRIX = [
    (["-ps", "-g60x20", "-b", "black"], ["noise_64x48.png"]),
    (["-ps", "-g60x20", "-b", "black"], ["gradient_320x200.png"]),
    # 80x100 -> a height of no multiple of 6: the composed pad strip
    (["-ps", "-g60x20", "-b", "#336699"], ["alpha_80x100.png"]),
    (["-ps", "-g60x20", "-b", "none"], ["alpha_80x100.png"]),
    (["-ps", "-g60x20", "-b", "black", "--title", "-C"],
     ["gradient_320x200.png"]),
    (["-ps", "-g60x20", "-b", "black"],
     ["noise_64x48.png", "gray_50x40.png"]),
]
PIXEL_CASES = ([("iterm2",) + m for m in ITERM_MATRIX]
               + [("kitty",) + m for m in KITTY_MATRIX]
               + [("sixel",) + m for m in SIXEL_MATRIX])


@pytest.mark.parametrize("proto,flags,files", PIXEL_CASES,
                         ids=[" ".join(m[1]) + ":" + ",".join(m[2])
                              for m in PIXEL_CASES])
def test_fast_pixel_protocols(corpus, proto, flags, files, tmp_path, capsys):
    # the first case of each protocol is held to the port's CLI too
    first = {"iterm2": ITERM_MATRIX[0][0], "kitty": KITTY_MATRIX[0][0],
             "sixel": SIXEL_MATRIX[0][0]}[proto] == flags
    _run_both(BASE + flags + [corpus[f] for f in files], tmp_path, capsys,
              cli=first and len(files) == 1)


@pytest.mark.parametrize("flags", [["-pi", "-g60x20", "-b", "black"],
                                   ["-pk", "-g60x20", "-b", "black"],
                                   ["-ps", "-g60x20", "-b", "black"]])
def test_fast_pixel_jpeg(flags, pil_stills, tmp_path, capsys):
    _run_both(BASE + flags + [pil_stills["jpg"]], tmp_path, capsys,
              cli=True)


def test_fast_auto_sieve_pixel_direct(corpus, tmp_path, capsys,
                                      monkeypatch):
    """Auto-detection resolving to each pixel protocol stays on the fast
    path (kitty inside tmux bails: passthrough needs the full canvas);
    both packages' terminal modules answer alike."""
    from timg_tpu import term as jax_term
    from timg_tpu.options import SixelOptions as JaxSixel
    from timg_tpu_torch import term
    from timg_tpu_torch.options import SixelOptions

    class TS:
        cols, rows = 82, 26
        font_width_px, font_height_px = 8, 16

    class GI:
        preferred_graphics = "iterm2"
        in_tmux = False
        sixel = SixelOptions()

    class JaxGI(GI):
        sixel = JaxSixel()

    for mod, gi in ((term, GI), (jax_term, JaxGI)):
        monkeypatch.setattr(mod, "determine_term_size", lambda: TS())
        monkeypatch.setattr(mod, "query_supported_graphics_protocol",
                            lambda gi=gi: gi())
    argv = BASE + ["-b", "black", corpus["noise_64x48.png"]]
    for proto in ("iterm2", "kitty", "sixel"):
        GI.preferred_graphics = JaxGI.preferred_graphics = proto
        _run_both(argv, tmp_path, capsys)
    GI.preferred_graphics = JaxGI.preferred_graphics = "kitty"
    GI.in_tmux = JaxGI.in_tmux = True
    assert fast.try_fast_main(argv + ["-o", os.devnull]) is None


# -------------------------------------------------------------------------
# Seeded fuzz: any combination the fast path takes is the JAX fast path's
# bytes, every third one the port CLI's too; a bail is a bail in both
# -------------------------------------------------------------------------

_FUZZ_POOL = [
    ["-pq"], ["-ph"], ["-ps"], ["-pk"], ["-pi"],
    ["-b", "black"], ["-b", "none"], ["-b", "#334455"], ["-b", "auto"],
    ["-B", "gray"], ["--pattern-size", "3"],
    ["--title"], ["--title=%b %wx%h %D"], ["-C"], ["-W"], ["-U"],
    ["--upscale=i"], ["-a"], ["--rotate", "off"], ["--color8"],
    ["--compress=4"], ["--clear"], ["-E"], ["-w", "0"],
]


def test_fast_fuzz(corpus, tmp_path, capsys):
    import random

    rng = random.Random(23)
    images = [corpus[k] for k in ("noise_64x48.png", "alpha_80x100.png",
                                  "gradient_320x200.png", "tiny_8x6.png",
                                  "gray_50x40.png")]
    ran = 0
    for i in range(40):
        argv = ["--debug-no-frame-delay",
                "-g", rng.choice(["80x24", "40x12", "23x9"])]
        for f in rng.sample(_FUZZ_POOL, rng.randint(1, 4)):
            argv += f
        argv += rng.sample(images, rng.randint(1, 2))
        got = _triple(fast.try_fast_main, argv, str(tmp_path / f"f{i}"),
                      capsys, pin=7000 + i * 8)
        want = _triple(jax_fast.try_fast_main, argv,
                       str(tmp_path / f"j{i}"), capsys, pin=7000 + i * 8)
        assert got == want, argv
        if got[0] is None:
            continue
        ran += 1
        if ran % 3 == 0:
            from timg_tpu_torch.cli import main

            assert got == _triple(main, argv, str(tmp_path / f"c{i}"),
                                  capsys, pin=7000 + i * 8), argv
    assert ran >= 15  # the sweep must exercise the fast path
