"""timg-tpu-torch-fast against timg-tpu-torch, continued: the stills the
binary decodes beside PNG -- JPEG (through Pillow's own libjpeg, or a
bail where it has no JPEG decoder), GIF and BMP -- and one invocation
mixing them with an animation and a missing file
(tests/test_fastlauncher.py's matrices).

With TIMG_TPU_TORCH_DEVICE=cpu both launchers must give the same
(output bytes, stderr, exit code); as in tests/test_torch_fastlauncher.py
one warm CPU server answers every invocation that reaches the CLI, from
either launcher.

Tolerance: none -- byte equality.
"""

from __future__ import annotations

import pytest

# the fixtures are used by name
from tests.test_torch_fastlauncher import (  # noqa: F401
    _both, binary, corpus, cpu_env, server)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Baseline, progressive, grayscale and quality variants, a large
    image the decode drafts, EXIF orientations 1 and 6, CMYK: the C
    decoder matches PIL (it dlopens Pillow's own libjpeg) or bails."""
    import numpy as np
    from PIL import Image

    tmp = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(2)
    smooth = (np.linspace(0, 255, 640)[None, :, None] *
              np.ones((480, 1, 3))).astype(np.uint8)
    noise = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    out = {}

    def mk(name, img, **kw):
        out[name] = str(tmp / name)
        img.save(out[name], **kw)

    mk("smooth_q85.jpg", Image.fromarray(smooth), quality=85)
    mk("noise_q50.jpg", Image.fromarray(noise), quality=50)
    mk("prog.jpg", Image.fromarray(smooth), quality=70, progressive=True)
    mk("gray.jpg", Image.fromarray(
        rng.integers(0, 256, (100, 130), dtype=np.uint8)), quality=80)
    mk("big_draft.jpg", Image.fromarray(
        rng.integers(0, 256, (1200, 1600, 3), dtype=np.uint8)), quality=60)
    mk("subs0.jpg", Image.fromarray(smooth), quality=90, subsampling=0)
    img = Image.fromarray(noise)
    ex = img.getexif()
    ex[0x0112] = 6
    mk("exif6.jpg", img, exif=ex)
    ex[0x0112] = 1
    mk("exif1.jpg", img, exif=ex)
    mk("cmyk.jpg", Image.fromarray(noise).convert("CMYK"))
    return out


@pytest.mark.parametrize("flags", [
    ["-pq", "-g80x24", "-b", "black"],
    ["-pi", "-g40x20"],
    ["-ps", "-g40x20", "-b", "black"],
    ["-pq", "-g80x24", "-b", "black", "--title"],
    ["-pq", "-g80x24", "-b", "black", "--rotate", "off"],
])
def test_jpeg_matches_python_launcher(binary, cpu_env, jpegs, flags,
                                      tmp_path):
    for name, path in sorted(jpegs.items()):
        c, py = _both(binary, flags + ["--debug-no-frame-delay"], [path],
                      tmp_path, cpu_env)
        assert c == py, (name, flags)


@pytest.fixture(scope="module")
def gifs(tmp_path_factory):
    """GIF stills: palettes of every size class, transparency (index 0
    too), interlace, RGB and L saves, degenerate geometry; and an
    animation."""
    import numpy as np
    from PIL import Image

    tmp = tmp_path_factory.mktemp("gifs")
    rng = np.random.default_rng(9)
    out = {}

    def save(name, im, **kw):
        out[name] = str(tmp / name)
        im.save(out[name], **kw)

    for i, (h, w, nc) in enumerate([(40, 52, 256), (23, 31, 16), (8, 8, 2),
                                    (1, 1, 2), (200, 3, 128)]):
        im = Image.fromarray(rng.integers(0, nc, (h, w)).astype(np.uint8),
                             "P")
        im.putpalette(bytes(rng.integers(0, 256, nc * 3).astype(np.uint8)))
        save(f"p{i}.gif", im)
    im = Image.fromarray(rng.integers(0, 16, (30, 40)).astype(np.uint8), "P")
    im.putpalette(bytes(range(48)))
    save("trans.gif", im, transparency=7)
    save("trans0.gif", im, transparency=0)
    save("inter.gif", im, interlace=True)
    save("rgb.gif", Image.fromarray(
        rng.integers(0, 256, (33, 47, 3), dtype=np.uint8), "RGB"))
    save("gray.gif", Image.fromarray(
        rng.integers(0, 256, (25, 25), dtype=np.uint8), "L"))
    frames = [Image.fromarray(rng.integers(0, 256, (16, 16, 3),
                                           dtype=np.uint8), "RGB")
              for _ in range(3)]
    out["anim.gif"] = str(tmp / "anim.gif")
    frames[0].save(out["anim.gif"], save_all=True, append_images=frames[1:],
                   duration=30, loop=0)
    return out


@pytest.mark.parametrize("flags", [
    ["-pq", "-g40x20", "-b", "black"],
    ["-pq", "-g40x20", "-b", "none"],
    ["-pi", "-g40x20"],
    ["-ps", "-g30x15", "-b", "#223344", "--title"],
])
def test_gif_matches_python_launcher(binary, cpu_env, gifs, flags,
                                     tmp_path):
    for name, path in sorted(gifs.items()):
        c, py = _both(binary, flags + ["--debug-no-frame-delay",
                                       "--loops=1"], [path], tmp_path,
                      cpu_env)
        assert c == py, (name, flags)


def test_bmp_and_mixed(binary, cpu_env, corpus, jpegs, tmp_path_factory,
                       tmp_path):
    """BMP stills (24-bit, gray, palette; 32-bit delegates), then one
    invocation mixing a PNG, an animation, a missing file and a JPEG."""
    import numpy as np
    from PIL import Image

    tmp = tmp_path_factory.mktemp("bmp")
    rng = np.random.default_rng(8)
    files = []
    for name, im in (
            ("rgb.bmp", Image.fromarray(rng.integers(
                0, 256, (33, 47, 3), dtype=np.uint8), "RGB")),
            ("gray.bmp", Image.fromarray(rng.integers(
                0, 256, (20, 30), dtype=np.uint8), "L")),
            ("rgba32.bmp", Image.fromarray(rng.integers(
                0, 256, (20, 20, 4), dtype=np.uint8), "RGBA"))):
        files.append(str(tmp / name))
        im.save(files[-1])
    pimg = Image.fromarray(rng.integers(0, 16, (20, 30)).astype(np.uint8),
                           "P")
    pimg.putpalette(bytes(rng.integers(0, 256, 48).astype(np.uint8)))
    files.append(str(tmp / "pal.bmp"))
    pimg.save(files[-1])
    for flags in (["-pq", "-g40x20", "-b", "black"], ["-pi", "-g40x20"]):
        for f in files:
            c, py = _both(binary, flags + ["--debug-no-frame-delay"], [f],
                          tmp_path, cpu_env)
            assert c == py, (f, flags)
    anim = str(tmp / "basic.gif")
    frames = [Image.fromarray(rng.integers(0, 256, (24, 32, 3),
                                           dtype=np.uint8), "RGB")
              for _ in range(4)]
    frames[0].save(anim, save_all=True, append_images=frames[1:],
                   duration=30, loop=0)
    c, py = _both(binary, ["-pq", "-g40x20", "-b", "black", "--loops=2",
                           "--debug-no-frame-delay"],
                  [corpus["noise_64x48.png"], anim,
                   "/nonexistent.png", jpegs["smooth_q85.jpg"]], tmp_path,
                  cpu_env)
    assert c == py
    assert c[0] == 1
