"""The port's CLI in kitty and iTerm2, and with --resample=sws-bitexact,
against the JAX package's CLI.

Each case runs the JAX CLI (JAX_PLATFORMS=cpu) and the port's
(TIMG_TPU_TORCH_DEVICE=cpu, the plain versions of the kernels) on the
same file and flags under the scripted pty of tests/test_torch_cli.py
(8x16-pixel cells); the streams must be byte-identical.  Kitty image
ids are seeded from the clock, so both packages' id state is pinned
before each run.  Inputs: tests/corpus.py's seeded corpus, an 800x600
JPEG, and the 4:2:0 y4m clips of tests/test_torch_cli.py (libav opens
them).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

from tests.corpus import build_corpus  # noqa: E402
from tests.test_torch_cli import _run_pty, _y4m, native  # noqa: E402,F401


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("pixel")
    out = build_corpus(str(d))
    yy, xx = np.mgrid[0:600, 0:800]
    photo = np.stack([xx * 255 // 800, yy * 255 // 600,
                      (xx ^ yy) & 255], -1).astype(np.uint8)
    Image.fromarray(photo).save(d / "photo_800x600.jpg", quality=90)
    out["photo_800x600.jpg"] = str(d / "photo_800x600.jpg")
    return out


def _pin_ids():
    """Both packages' kitty id state, as a fresh process after the same
    clock reading has it."""
    from timg_tpu.render import kitty as jkitty
    from timg_tpu_torch.render import kitty as tkitty
    for mod in (jkitty, tkitty):
        mod._id_start = 400000
        mod._id_counter = 0


def _compare(tmp_path, argv):
    from timg_tpu.cli import main as jax_main
    from timg_tpu_torch.cli import main as torch_main

    argv = ["--debug-no-frame-delay"] + argv
    _pin_ids()
    want = _run_pty(jax_main, argv, tmp_path / "jax.out")
    _pin_ids()
    got = _run_pty(torch_main, argv, tmp_path / "torch.out")
    assert got == want
    assert len(got) > 100
    return got


_PROTOCOLS = {"kitty": ["-g40x20", "-pk"], "iterm2": ["-g40x20", "-pi"]}
_STILLS = {
    "alpha-none": ["-b", "none", "alpha_80x100.png"],
    "alpha-auto": ["-b", "auto", "alpha_80x100.png"],
    "alpha-checker": ["-b", "white", "-B", "#808080",
                      "alpha_band_60x40.png"],
    "jpeg": ["-b", "black", "photo_800x600.jpg"],
    "gif": ["-b", "black", "--loops=1", "anim_32x24.gif"],
    "grid": ["-b", "black", "--grid=2x2", "noise_64x48.png",
             "alpha_80x100.png", "gray_50x40.png", "gradient_320x200.png"],
    "multi-chunk": ["-b", "black", "--compress=6", "noise_512x512.png"],
}


@pytest.mark.parametrize("still", list(_STILLS))
@pytest.mark.parametrize("protocol", list(_PROTOCOLS))
def test_still_stream_matches_jax(tmp_path, files, protocol, still):
    argv = _PROTOCOLS[protocol] + [files.get(a, a) for a in _STILLS[still]]
    got = _compare(tmp_path, argv)
    head = b"\033_Ga=T" if protocol == "kitty" else b"\033]1337;File="
    assert head in got
    if still == "gif":
        assert got.count(head) == 4
    if still == "multi-chunk" and protocol == "kitty":
        assert got.count(b"\033_Gq=2,m=") > 1


@pytest.mark.parametrize("flags", [
    pytest.param(["-pk"], id="kitty"),
    pytest.param(["-pi"], id="iterm2"),
    pytest.param(["-pk", "--resample=sws-bitexact"], id="kitty-sws"),
    pytest.param(["-pi", "--resample=sws-bitexact"], id="iterm2-sws"),
    pytest.param(["-ps", "--dither=cube", "--resample=sws-bitexact"],
                 id="cube-sws"),
    pytest.param(["-ps", "--dither=libsixel", "--resample=sws-bitexact"],
                 id="libsixel-sws"),
    pytest.param(["-pq", "--resample=sws-bitexact"], id="pq-sws"),
    pytest.param(["-ph", "--resample=sws-bitexact"], id="ph-sws")])
def test_video_stream_matches_jax(native, tmp_path, flags):
    """The 4:2:0 clip through the pixel window (convert and resize, or
    the sws kernel), and --resample=sws-bitexact in the sixel and block
    windows; kitty's animation ids flip between two."""
    clip = _y4m(tmp_path)
    got = _compare(tmp_path, ["-g40x20", *flags, "-b", "black", "--loops=1",
                              clip])
    if "-pk" in flags:
        assert got.count(b"\033_Ga=T,i=400001,") == 3
        assert got.count(b"\033_Ga=T,i=400002,") == 2
    if "-pi" in flags:
        assert got.count(b"\033]1337;File=") == 5
    if "-ps" in flags:
        assert got.count(b"\033Pq") == 5


@pytest.mark.parametrize("flags,size", [
    pytest.param(["-pk"], (33, 21), id="kitty-odd-width"),
    pytest.param(["-pq"], (33, 21), id="pq-odd-width")])
def test_sws_video_full_chroma_matches_jax(native, tmp_path, flags, size):
    """A 33x21 clip fits the canvas unscaled in kitty (an odd width: the
    full-chroma path) and, in quarter blocks, renders frame by frame."""
    clip = _y4m(tmp_path, *size)
    _compare(tmp_path, ["-g40x20", *flags, "-b", "black", "--loops=1",
                        "--resample=sws-bitexact", clip])


def test_pixel_window_disabled_writes_the_same_stream(native, tmp_path,
                                                      monkeypatch):
    """TIMG_TPU_VIDEO_DEVICE_WINDOW=0: the frames come back at once
    instead of lazily; the stream does not change."""
    clip = _y4m(tmp_path)
    argv = ["-g40x20", "-pk", "-b", "black", "--loops=1", clip]
    want = _compare(tmp_path, argv)
    monkeypatch.setenv("TIMG_TPU_VIDEO_DEVICE_WINDOW", "0")
    assert _compare(tmp_path, argv) == want


@pytest.mark.parametrize("reply,head", [
    pytest.param(b"\033P>|kitty(0.35.2)\033\\", b"\033_Ga=T", id="kitty"),
    pytest.param(b"\033P>|iTerm2 3.5.0\033\\", b"\033]1337;File=",
                 id="iterm2"),
    pytest.param(b"\033P>|tmux 3.4\033\\\033P>|kitty(0.35.2)\033\\",
                 b"\033Ptmux;", id="kitty-in-tmux")])
def test_terminal_choice_matches_jax(tmp_path, files, monkeypatch, reply,
                                     head):
    """No -p: the terminal's answer to the version query picks kitty or
    iTerm2 (kitty inside tmux: passthrough-wrapped chunks and
    unicode-placeholder tiles), where the port refused both before."""
    from tests.test_protocols import _with_scripted_pty
    from timg_tpu.cli import main as jax_main
    from timg_tpu_torch.cli import main as torch_main

    monkeypatch.setenv("TERM", "xterm-256color")
    for var in ("TERM_PROGRAM", "TMUX"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--debug-no-frame-delay", "-g40x20", "-b", "black",
            files["noise_64x48.png"]]

    def run(main, out_path):
        def inner(slave):
            saved = os.dup(1)
            try:
                os.dup2(slave, 1)
                assert main(argv + ["-o", str(out_path)]) == 0
            finally:
                os.dup2(saved, 1)
                os.close(saved)
            return out_path.read_bytes()

        _pin_ids()
        return _with_scripted_pty(inner, {b"\033[>q": reply + b"\033[0n"})

    want = run(jax_main, tmp_path / "jax.out")
    got = run(torch_main, tmp_path / "torch.out")
    assert got == want
    assert head in got
