"""The port's CLI with ``--devices 4`` against the JAX CLI with
``--devices 4`` and against the port's single-device run, on the CPU.

The JAX CLI runs in-process on the suite's virtual 8-device CPU mesh
with TIMG_TPU_FORCE_DEVICE=1, so its routed dispatches take the sharded
jax path (as tests/test_multichip_cli.py runs it); the port runs its
plain versions on four shards of the one CPU device
(parallel/auto.py), so the split, the padding and the gather are what
is held to the single-device bytes.  Every run is under the scripted
pty of tests/test_torch_cli.py (8x16-pixel cells, so windows of several
frames render); kitty ids are pinned before each run.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

from tests.test_multichip_cli import _make_y4m  # noqa: E402
from tests.test_torch_cli import _run_pty, native  # noqa: E402,F401
from tests.test_torch_pixel_cli import _pin_ids  # noqa: E402
from timg_tpu_torch.parallel import auto  # noqa: E402

BASE = ["-g40x12", "--debug-no-frame-delay", "-b", "black", "--loops=1"]


@pytest.fixture(scope="module")
def y4m(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("mc") / "v.y4m")
    _make_y4m(p)        # 64x48, 6 frames: one window, padded to 8
    return p


def _run(main, argv, out, monkeypatch, devices=None, jax=False):
    for k in ("TIMG_TPU_DEVICES", "TIMG_TPU_FORCE_NUMPY"):
        monkeypatch.delenv(k, raising=False)
    if jax:
        monkeypatch.setenv("TIMG_TPU_FORCE_DEVICE", "1")
    else:
        monkeypatch.delenv("TIMG_TPU_FORCE_DEVICE", raising=False)
    full = list(argv)
    if devices is not None:
        full = ["--devices", str(devices)] + full
    _pin_ids()
    auto.SHARDS.clear()
    try:
        return _run_pty(main, full, out)
    finally:
        # --devices sets the env for the dispatch layer; scrub it so the
        # next in-process run starts clean
        os.environ.pop("TIMG_TPU_DEVICES", None)


def _three(argv, tmp_path, monkeypatch):
    """(port --devices 4, the shards' keys, port single, JAX --devices 4)."""
    from timg_tpu.cli import main as jax_main
    from timg_tpu_torch.cli import main as torch_main

    sharded = _run(torch_main, argv, tmp_path / "t4.out", monkeypatch, 4)
    keys = dict(auto.SHARDS)
    single = _run(torch_main, argv, tmp_path / "t1.out", monkeypatch)
    assert not auto.SHARDS
    jax4 = _run(jax_main, argv, tmp_path / "j4.out", monkeypatch, 4,
                jax=True)
    return sharded, keys, single, jax4


# mode -> (flags, shard keys the port's run must have used)
VIDEO = {
    "cube": (["-ps", "--dither=cube"], ("video_lean", "sixel_cube")),
    "libsixel": (["-ps", "--dither=libsixel"],
                 ("video_lean", "libsixel_table")),
    "adaptive": (["-ps", "--dither=adaptive"], ("video_lean", "sixel_tree")),
    "pq": (["-pq"], ("video_lean", "blocks")),
    "ph": (["-ph"], ("video_lean", "blocks")),
    "pk": (["-pk"], ("video_lean",)),
    "cube-sws": (["-ps", "--dither=cube", "--resample=sws-bitexact"],
                 ("video_sws", "sixel_cube")),
}


@pytest.mark.parametrize("mode", list(VIDEO))
def test_video_sharded_matches(native, y4m, tmp_path, monkeypatch, mode):
    flags, want_keys = VIDEO[mode]
    sharded, keys, single, jax4 = _three(flags + BASE + [y4m], tmp_path,
                                         monkeypatch)
    assert len(single) > 100
    assert sharded == single == jax4
    used = {k[0] for k in keys}
    assert set(want_keys) <= used, used
    assert all(v == ["cpu"] * 4 for v in keys.values())


def test_animation_batch_pads(tmp_path, monkeypatch):
    """A 5-frame GIF: the RGBA window's 5 frames over 4 shards (padded
    to 8, the padding sliced off) in blocks and in cube."""
    from PIL import Image

    rng = np.random.default_rng(7)
    frames = [Image.fromarray(
        rng.integers(0, 256, (24, 32, 3), dtype=np.uint8), "RGB")
        for _ in range(5)]
    gif = str(tmp_path / "a.gif")
    frames[0].save(gif, save_all=True, append_images=frames[1:],
                   duration=50, loop=1)
    for flags, key in ((["-pq"], "blocks"),
                       (["-ps", "--dither=cube"], "sixel_cube")):
        sharded, keys, single, jax4 = _three(flags + BASE + [gif], tmp_path,
                                             monkeypatch)
        assert sharded == single == jax4
        assert key in {k[0] for k in keys}


def test_still_spatial_route(tmp_path, monkeypatch):
    """A 2048x2048 still with --devices 4: its output rows split over
    the four shards, each with its halo of input rows (the JAX CLI's
    ('data', 'space') route), the same bytes as one device."""
    from PIL import Image

    side = 2048
    row = np.linspace(0, 255, side, dtype=np.uint8)
    img = np.empty((side, side, 4), np.uint8)
    img[..., 0] = row[None, :]
    img[..., 1] = row[:, None]
    img[..., 2] = 128
    img[..., 3] = 255
    img[300:700, 500:1500] = (200, 30, 90, 255)
    img[1200:1600, 100:900, 3] = np.linspace(0, 255, 800).astype(np.uint8)
    png = str(tmp_path / "big.png")
    Image.fromarray(img, "RGBA").save(png, compress_level=1)
    sharded, keys, single, jax4 = _three(["-pq", "-g80x24",
                                          "--debug-no-frame-delay", "-b",
                                          "black", png], tmp_path,
                                         monkeypatch)
    assert sharded == single == jax4
    assert "still_resize" in {k[0] for k in keys}
