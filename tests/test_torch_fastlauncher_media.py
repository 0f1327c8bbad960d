"""timg-tpu-torch-fast against timg-tpu-torch, continued: what the binary
renders beyond a still -- contact sheets and GIF animations -- and the
pixel protocols' grids and animations under scripted ptys
(tests/test_fastlauncher.py's matrices).

With TIMG_TPU_TORCH_DEVICE=cpu both launchers must give the same
(output bytes, stderr, exit code); as in tests/test_torch_fastlauncher.py
one warm CPU server answers every invocation that reaches the CLI, from
either launcher.

Tolerance: none -- byte equality (kitty ids compared modulo id).
"""

from __future__ import annotations

import pytest

# the fixtures are used by name
from tests.test_torch_fastlauncher import (  # noqa: F401
    _TERMS, _both, _pty_both, binary, cpu_env, server)


@pytest.fixture(scope="module")
def grid_media(tmp_path_factory):
    import numpy as np
    from PIL import Image

    tmp = tmp_path_factory.mktemp("grid")
    rng = np.random.default_rng(11)
    jpgs = []
    for i in range(8):
        p = str(tmp / f"img{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (480, 640, 3),
                                     dtype=np.uint8), "RGB").save(
            p, quality=80)
        jpgs.append(p)
    png = str(tmp / "odd.png")
    Image.fromarray(rng.integers(0, 256, (123, 77, 4), dtype=np.uint8),
                    "RGBA").save(png)
    return jpgs, png


@pytest.mark.parametrize("flags,n", [
    (["-ph", "--grid=4x2", "--title", "-g160x48", "-b", "black"], 8),
    (["-pq", "--grid=3", "-g120x40", "-b", "black"], 7),
    (["-ph", "--grid=2x2", "-g80x24", "-b", "black", "--title", "-C"], 4),
    (["-ph", "--grid=1x2", "-g80x24", "-b", "black", "--title"], 2),
    (["-pq", "--grid=5x1", "-g100x20", "-b", "none"], 6),
    (["-ph", "--grid=4x2", "--title", "-g161x49", "-b", "#446688",
      "-C"], 8),
])
def test_grid_matches_python_launcher(binary, cpu_env, grid_media, flags, n,
                                      tmp_path):
    """Contact sheets the binary renders itself: the port's CLI's
    MultiColumnRenderer bytes."""
    jpgs, png = grid_media
    c, py = _both(binary, flags + ["--debug-no-frame-delay"],
                  (jpgs + [png])[:n], tmp_path, cpu_env)
    assert c == py


def test_grid_missing_files_and_bails(binary, cpu_env, grid_media,
                                      tmp_path):
    """Failed sources never advance the grid column; out-of-envelope
    grids (pixel-direct, bad specs) delegate with the same result."""
    jpgs, png = grid_media
    c, py = _both(binary, ["-pq", "--grid=2", "-g80x24", "-b", "black",
                           "--debug-no-frame-delay"],
                  [jpgs[0], "/nonexistent.png", png, jpgs[1]], tmp_path,
                  cpu_env)
    assert c == py
    assert c[0] == 1
    for flags in (["-pi", "--grid=2x2", "-g80x24"],
                  ["-pq", "--grid=bogus", "-g80x24"],
                  ["-pq", "--grid=0", "-g80x24"]):
        c, py = _both(binary, flags + ["--debug-no-frame-delay"], jpgs[:4],
                      tmp_path, cpu_env)
        assert c == py, flags


@pytest.fixture(scope="module")
def anim_gifs(tmp_path_factory):
    """Animations: RGB full frames, a shared palette with transparency
    and disposals 1, 2 and 3, per-frame delays, static frames."""
    import numpy as np
    from PIL import Image

    tmp = tmp_path_factory.mktemp("anim")
    rng = np.random.default_rng(21)
    out = {}

    def mk(name, frames, **kw):
        out[name] = str(tmp / name)
        frames[0].save(out[name], save_all=True, append_images=frames[1:],
                       **kw)

    fr = [Image.fromarray(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8),
                          "RGB") for _ in range(4)]
    mk("basic.gif", fr, duration=30, loop=0)
    mk("slowfast.gif", fr, duration=[500, 5, 20, 1000], loop=0)
    pal = bytes(rng.integers(0, 256, 48).astype(np.uint8))
    pf = []
    for _ in range(4):
        im = Image.fromarray(rng.integers(0, 16, (20, 28)).astype(np.uint8),
                             "P")
        im.putpalette(pal)
        pf.append(im)
    mk("ptrans_d2.gif", pf, duration=40, loop=0, transparency=3, disposal=2)
    mk("ptrans_d1.gif", pf, duration=40, loop=0, transparency=3, disposal=1)
    mk("p_d3.gif", pf, duration=40, loop=0, disposal=3)
    same = [Image.fromarray(np.full((16, 24, 3), 128, np.uint8), "RGB")
            for _ in range(3)]
    mk("static.gif", same, duration=25, loop=0)
    return out


@pytest.mark.parametrize("flags", [
    ["-pq", "-g40x20", "-b", "black", "--loops=2"],
    ["-ph", "-g40x20", "-b", "black", "--loops=1", "-C"],
    ["-pk", "-g40x20", "--loops=2"],          # no tty: one-frame path
    ["-pq", "-g40x20", "-b", "black", "-t", "0.12"],
    ["-pq", "-g40x20", "-b", "none", "--loops=2", "--title"],
    ["-ps", "-g40x20", "-b", "black", "--loops=2"],
    ["-ps", "-g40x20", "-b", "none", "--loops=1", "--title"],
    ["-pi", "-g40x20", "--loops=2"],
])
def test_gif_animation_matches_python(binary, cpu_env, anim_gifs, flags,
                                      tmp_path):
    """Animations the binary renders itself (disposal compositing, frame
    pacing, block diffs, the bucket-table sixel pipeline): the port's
    CLI's bytes."""
    for name, path in sorted(anim_gifs.items()):
        c, py = _both(binary, flags + ["--debug-no-frame-delay"], [path],
                      tmp_path, cpu_env)
        assert c == py, (name, flags)


@pytest.mark.parametrize("term,mode", [
    ("kitty", "-pk"), ("iterm2", "-pi"), ("xterm-sixel", "-ps"),
])
def test_pixel_grid_and_animations_under_pty(binary, cpu_env, grid_media,
                                             anim_gifs, term, mode,
                                             tmp_path):
    """With a known cell size: pixel contact sheets (per-canvas cell
    rounding, canvas cursor moves) and pixel animations (the bucket-table
    sixel pipeline, iTerm2 frames, kitty's flip-flop ids)."""
    jpgs, png = grid_media
    for flags in ([mode, "--grid=2x2", "-g40x20"],
                  [mode, "--grid=3", "-g60x20", "--title", "-b", "black"]):
        _pty_both(binary, flags + ["--debug-no-frame-delay"],
                  jpgs[:4] + [png], _TERMS[term], tmp_path, cpu_env)
    loops = "--loops=3" if mode == "-pk" else "--loops=2"
    for name in ("basic.gif", "ptrans_d2.gif"):
        _pty_both(binary, [mode, "-g40x20", loops, "--debug-no-frame-delay",
                           "-b", "black"], [anim_gifs[name]], _TERMS[term],
                  tmp_path, cpu_env)

