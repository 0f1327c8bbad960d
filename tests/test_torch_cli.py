"""The port's CLI (timg_tpu_torch.cli) against the JAX package's CLI.

The same y4m clip goes through both CLIs under a scripted pty; the sixel
streams must be byte-identical, in every --dither mode, and so must the
quarter- and half-block streams.  The port never
imports jax, which a subprocess run shows, and what it once refused now
runs (stills: tests/test_torch_stills_cli.py; kitty, iTerm2 and
--resample=sws-bitexact: tests/test_torch_pixel_cli.py; the RGBA and
scaled video windows with --resample=sws: tests/test_torch_video_rgba.py;
the other decoders: tests/test_torch_decoders.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--debug-no-frame-delay", "-g40x20", "-ps", "--dither=cube",
        "-b", "black", "--loops=1"]


def _need_native():
    from timg_tpu.native import runtime
    if runtime.load() is None:
        pytest.skip("native video helper unavailable")


@pytest.fixture
def native():
    _need_native()


def _y4m(tmp_path, w=64, h=48, n=5):
    p = tmp_path / "v.y4m"
    rng = np.random.default_rng(9)
    with open(p, "wb") as f:
        f.write(("YUV4MPEG2 W%d H%d F25:1 Ip A1:1 C420jpeg\n"
                 % (w, h)).encode())
        for i in range(n):
            y = np.full((h, w), 70 + 15 * i, np.uint8)
            y[:, w // 3:] = 180 - 10 * i
            y[10:30, 10:40] = rng.integers(16, 236, y[10:30, 10:40].shape,
                                           dtype=np.uint8)
            f.write(b"FRAME\n")
            f.write(y.tobytes())
            ch, cw = (h + 1) // 2, (w + 1) // 2
            f.write(rng.integers(100, 160, (ch, cw), dtype=np.uint8)
                    .tobytes())
            f.write(np.full((ch, cw), 135, np.uint8).tobytes())
    return str(p)


def _run_pty(main, argv, out_path):
    from tests.test_protocols import _with_scripted_pty

    def inner(slave):
        saved = os.dup(1)
        try:
            os.dup2(slave, 1)
            rc = main(argv + ["-o", str(out_path)])
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        assert rc == 0
        return out_path.read_bytes()

    return _with_scripted_pty(inner, {})


@pytest.mark.parametrize("geometry,dither", [
    pytest.param("-g40x20", "--dither=cube", id="-g40x20"),
    pytest.param("-g33x17", "--dither=cube", id="-g33x17"),
    pytest.param("-g40x20", "--dither=libsixel", id="-g40x20-libsixel"),
    pytest.param("-g33x17", "--dither=libsixel", id="-g33x17-libsixel"),
    pytest.param("-g40x20", "--dither=adaptive", id="-g40x20-adaptive"),
    pytest.param("-g33x17", "--dither=adaptive", id="-g33x17-adaptive"),
    pytest.param("-g40x20", "--dither=auto", id="-g40x20-auto"),
    pytest.param("-g40x20", None, id="-g40x20-default")])
def test_cli_stream_matches_jax(native, tmp_path, geometry, dither):
    """Each mode, and no --dither flag at all (the CLI default,
    libsixel)."""
    from timg_tpu.cli import main as jax_main
    from timg_tpu_torch.cli import main as torch_main

    clip = _y4m(tmp_path)
    argv = [geometry if a == "-g40x20" else dither if a == "--dither=cube"
            else a for a in ARGV if a != "--dither=cube" or dither] + [clip]
    want = _run_pty(jax_main, argv, tmp_path / "jax.out")
    got = _run_pty(torch_main, argv, tmp_path / "torch.out")
    assert got == want
    assert got.count(b"\033Pq") == 5


@pytest.mark.parametrize("flags,size", [
    pytest.param(["-pq"], (64, 48), id="-pq-g40x20"),
    pytest.param(["-pq", "--color8"], (64, 48), id="-pq-color8"),
    pytest.param(["-pq"], (33, 21), id="-pq-odd-height"),
    pytest.param(["-ph"], (64, 48), id="-ph-g40x20"),
    pytest.param(["-ph"], (33, 21), id="-ph-odd-width-and-height")])
def test_cli_block_stream_matches_jax(native, tmp_path, flags, size):
    """Quarter and half blocks on the same clip: the whole ANSI stream,
    diffs between frames included.  The 33x21 clip fits the 40x20-cell
    canvas unscaled, so its frames keep an odd height (and, in half
    blocks, an odd width)."""
    from timg_tpu.cli import main as jax_main
    from timg_tpu_torch.cli import main as torch_main

    clip = _y4m(tmp_path, *size)
    argv = ["--debug-no-frame-delay", "-g40x20", *flags, "-b", "black",
            "--loops=1", clip]
    want = _run_pty(jax_main, argv, tmp_path / "jax.out")
    got = _run_pty(torch_main, argv, tmp_path / "torch.out")
    assert got == want
    assert got.count(b"\033[0m\n") > 5


def test_cli_subprocess_never_imports_jax(native, tmp_path):
    """A cube run and a libsixel run (the CLI default)."""
    for dither in ("--dither=cube", "--dither=libsixel"):
        _run_without_jax(tmp_path, [dither if a == "--dither=cube" else a
                                    for a in ARGV])


def _run_without_jax(tmp_path, argv):
    from tests.test_protocols import _with_scripted_pty

    clip = _y4m(tmp_path)
    out = tmp_path / "sub.out"
    code = (
        "import sys, pkgutil, importlib\n"
        "import timg_tpu_torch\n"
        "for m in pkgutil.walk_packages(timg_tpu_torch.__path__,\n"
        "                               'timg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from timg_tpu_torch.cli import main\n"
        f"rc = main({argv + [clip, '-o', str(out)]!r})\n"
        "assert rc == 0, rc\n"
        "print('jax loaded:', 'jax' in sys.modules, file=sys.stderr)\n")
    env = dict(os.environ, TIMG_TPU_TORCH_DEVICE="cpu")

    def run(slave):
        return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env=env, stdin=slave, stdout=slave,
                              stderr=subprocess.PIPE, text=True,
                              timeout=300)

    proc = _with_scripted_pty(run, {})
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr.strip().splitlines()[-1] == "jax loaded: False"
    assert out.read_bytes().count(b"\033Pq") == 5


def test_cli_without_cuda_names_the_variable(monkeypatch, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from timg_tpu_torch.cli import main
    monkeypatch.delenv("TIMG_TPU_TORCH_DEVICE")
    rc = main(ARGV + [_y4m(tmp_path), "-o", str(tmp_path / "x.out")])
    assert rc != 0
    assert "TIMG_TPU_TORCH_DEVICE" in capsys.readouterr().err


@pytest.mark.parametrize("flags,what", [
    (["-pk"], "-p kitty graphics"),
    (["-pi"], "-p iterm2 graphics"),
    (["-ps", "--dither=cube", "--resample=sws"], "--resample=sws"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, capsys, flags, what):
    """What the port once refused now runs: -pk and -pi write their image
    (one frame: without a terminal the cell size is unknown; their
    streams against the JAX CLI: tests/test_torch_pixel_cli.py), and
    --resample=sws (the host swscale leg and its "scaled" window,
    refused until the RGBA and scaled windows were ported) writes the
    JAX CLI's stream (more: tests/test_torch_video_rgba.py)."""
    from timg_tpu.cli import main as jax_main
    from timg_tpu_torch.cli import main as torch_main
    _need_native()
    argv = ["--debug-no-frame-delay", "-g40x20", *flags, "--loops=1",
            _y4m(tmp_path)]
    out = tmp_path / "x.out"
    rc = torch_main(argv + ["-o", str(out)])
    err = capsys.readouterr().err
    assert rc == 0 and what not in err and "not yet ported" not in err
    if "--resample=sws" in flags:
        assert jax_main(argv + ["-o", str(tmp_path / "j.out")]) == 0
        assert out.read_bytes() == (tmp_path / "j.out").read_bytes()
        assert out.read_bytes().count(b"\033Pq") == 1
        return
    head = b"\033_Ga=T" if "-pk" in flags else b"\033]1337;File="
    assert out.read_bytes().count(head) == 1


def test_cli_refuses_an_image(native, tmp_path, capsys):
    """An image only a decoder the port once lacked opens (here a PDF),
    refused by name until the decoders were ported, now takes the JAX
    CLI's way: without poppler-glib both exit 1 with its gated
    diagnostic (PDF streams: tests/test_torch_decoders.py)."""
    from timg_tpu.cli import main as jax_main
    from timg_tpu_torch.cli import main as torch_main
    pdf = tmp_path / "s.pdf"
    pdf.write_bytes(b"%PDF-1.4\n%%EOF\n")
    rc = torch_main(ARGV + [str(pdf), "-o", str(tmp_path / "x.out")])
    err = capsys.readouterr().err
    assert jax_main(ARGV + [str(pdf), "-o", str(tmp_path / "j.out")]) == rc
    assert capsys.readouterr().err == err
    assert "not yet ported" not in err
    from timg_tpu_torch.sources.pdf_source import poppler_available
    if not poppler_available():
        assert rc != 0 and "poppler-glib" in err
