"""The port's sharding over cards (timg_tpu_torch/parallel/) on the CPU,
against the JAX package's (tests/test_parallel.py, on the suite's
virtual 8-device CPU mesh) and against the unsharded port.

On the CPU a "card" is the one CPU device, repeated: every shard runs
the plain versions, so the routing (the split, the padding, the halo of
the spatial bands, the gather) is what these tests hold to the
single-device bytes.  The ``cuda`` test needs two cards: every kernel
wrapper launched on cuda:1 writes what it writes on cuda:0.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

from timg_tpu_torch.ops import pipeline as tpipeline  # noqa: E402
from timg_tpu_torch.ops import resize as tresize  # noqa: E402
from timg_tpu_torch.ops.sixel_kernel import fs_dither_cube_fused  # noqa
from timg_tpu_torch.ops.yuv import yuv420_to_rgba_words  # noqa: E402
from timg_tpu_torch.parallel import auto, mesh  # noqa: E402

CPU = torch.device("cpu")


def _jax_devices(n):
    import jax
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")


@pytest.mark.parametrize("n,data", [(1, None), (2, None), (4, None),
                                    (8, None), (8, 8), (4, 1), (6, None)])
def test_mesh_shapes_follow_the_jax_package(n, data):
    from timg_tpu.parallel.mesh import make_mesh as jax_make_mesh

    _jax_devices(8)
    ours = mesh.make_mesh(n, data, devices=[CPU], repeat=True)
    theirs = jax_make_mesh(n, data)
    assert ours.shape == theirs.devices.shape
    assert ours.axis_names == theirs.axis_names == ("data", "space")
    assert all(d == CPU for d in ours.devices.flat)


def test_mesh_repeats_only_when_asked():
    with pytest.raises(ValueError):
        mesh.make_mesh(4, devices=[CPU])
    assert mesh.make_mesh(devices=[CPU]).shape == (1, 1)
    assert mesh.make_mesh().shape == (1, 1)       # the visible CPU


def _frames(seed, shape, opaque=False):
    f = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    if opaque:
        f[..., 3] = 255
    return f


@pytest.mark.parametrize("data", [4, 2])
def test_sharded_quarter_matches_jax_and_unsharded(data):
    """Batch over ``data``, height over ``space`` (the vertical taps'
    halo), the JAX test's geometry: the same planes as the JAX
    package's sharded pipeline and the port's unsharded one."""
    import jax.numpy as jnp

    from timg_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from timg_tpu.parallel.mesh import \
        sharded_quarter_pipeline as jax_sharded

    _jax_devices(8)
    theirs_mesh = jax_make_mesh(8, data)
    space = theirs_mesh.devices.shape[1]
    out_h, out_w = 16 * space, 32
    frames = _frames(0, (data * 2, 24 * space, 48, 4))
    with theirs_mesh:
        want = [np.asarray(p) for p in jax_sharded(
            theirs_mesh, out_h, out_w)(jnp.asarray(frames))]
    ours_mesh = mesh.make_mesh(8, data, devices=[CPU], repeat=True)
    got = mesh.sharded_quarter_pipeline(ours_mesh, out_h, out_w)(
        torch.from_numpy(frames))
    plain = tpipeline.quarter_pipeline(torch.from_numpy(frames), out_h,
                                       out_w, bg_color=(0, 0, 0, 255))
    for g, w, p in zip(got, want, plain):
        assert np.array_equal(g.numpy(), w)
        assert torch.equal(g, p)


@pytest.mark.parametrize("space", [3, 5])
def test_sharded_quarter_odd_splits(space):
    """More bands than the JAX test asks for, at heights a band does not
    divide, with upper blocks: still the unsharded planes."""
    grid = mesh.make_mesh(space, 1, devices=[CPU], repeat=True)
    frames = _frames(1, (3, 77, 50, 4))
    got = mesh.sharded_quarter_pipeline(grid, 22, 30, True)(
        torch.from_numpy(frames))
    plain = tpipeline.quarter_pipeline(torch.from_numpy(frames), 22, 30,
                                       bg_color=(0, 0, 0, 255),
                                       use_upper_half_block=True)
    assert all(torch.equal(g, p) for g, p in zip(got, plain))


@pytest.mark.parametrize("b", [8, 6])
def test_sharded_video_sixel_matches_jax_and_unsharded(b):
    """Words -> resize -> cube dither per data shard; 6 frames over 8
    shards pads the batch."""
    import jax
    import jax.numpy as jnp

    from timg_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from timg_tpu.parallel.mesh import \
        sharded_video_sixel_pipeline as jax_sharded

    _jax_devices(8)
    frames = _frames(2, (b, 48, 64, 4), opaque=True)
    words = frames.view(np.int32).reshape(frames.shape[:3])
    got = mesh.sharded_video_sixel_pipeline(
        mesh.make_mesh(8, 8, devices=[CPU], repeat=True), 24, 32)(
        torch.from_numpy(words))
    plain = fs_dither_cube_fused(tresize.resize_video_words(
        torch.from_numpy(words), 24, 32), 24, 32)
    assert torch.equal(got, plain)
    if b == 8:      # the JAX pipeline takes a batch the mesh divides
        mesh8 = jax_make_mesh(8, data=8)
        with mesh8:
            want = np.asarray(jax_sharded(mesh8, 24, 32)(
                jax.lax.bitcast_convert_type(jnp.asarray(frames),
                                             jnp.int32)))
        assert np.array_equal(got.numpy(), want)


def test_sharded_video_sixel_yuv_matches_unsharded():
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.integers(16, 236, (5, 48, 64), np.uint8))
    u = torch.from_numpy(rng.integers(16, 240, (5, 24, 32), np.uint8))
    v = torch.from_numpy(rng.integers(16, 240, (5, 24, 32), np.uint8))
    grid = mesh.make_mesh(4, 2, devices=[CPU], repeat=True)
    for full in (True, False):
        got = mesh.sharded_video_sixel_pipeline(grid, 24, 32, yuv=True,
                                                full_range=full)(y, u, v)
        words = tresize.resize_video_words(
            yuv420_to_rgba_words(y, u, v, full), 24, 32)
        assert torch.equal(got, fs_dither_cube_fused(words, 24, 32))


def test_shard_batch_call_single_device_is_none(monkeypatch):
    monkeypatch.delenv("TIMG_TPU_DEVICES", raising=False)
    assert auto.data_devices() is None
    assert auto.shard_batch_call(("t",), lambda x: x, [np.zeros(3)]) is None
    monkeypatch.setenv("TIMG_TPU_DEVICES", "auto")    # one CPU device
    assert auto.configured_devices() == 1
    monkeypatch.setenv("TIMG_TPU_DEVICES", "junk")
    assert auto.configured_devices() == 1


@pytest.mark.parametrize("b,n", [(8, 4), (6, 4), (5, 4), (1, 4), (3, 8)])
def test_shard_batch_call_pads_splits_and_gathers(monkeypatch, b, n):
    monkeypatch.setenv("TIMG_TPU_DEVICES", str(n))
    assert auto.data_devices() == [CPU] * n
    x = np.arange(b * 6, dtype=np.int32).reshape(b, 2, 3)
    seen = []

    def fn(a, k):
        seen.append(a.shape[0])
        return a * k, a[:, 0] + 1

    got = auto.shard_batch_call(("pad", b, n), fn, [x], [torch.tensor(3)])
    per = -(-b // n)
    assert seen == [per] * n                 # padded to a multiple of n
    assert np.array_equal(got[0], x * 3)
    assert np.array_equal(got[1], x[:, 0] + 1)
    assert auto.SHARDS[("pad", b, n)] == ["cpu"] * n
    shards = auto.shard_batch_call(("pad",), lambda a: a,
                                   [torch.from_numpy(x)], fetch=False)
    assert sum(s.shape[0] for s in shards) == b   # padding sliced off
    assert torch.equal(torch.cat(shards), torch.from_numpy(x))


def test_shard_batch_call_raises_a_failed_shard(monkeypatch):
    """A shard that fails fails the call: nothing falls back to one
    device."""
    monkeypatch.setenv("TIMG_TPU_DEVICES", "2")
    calls = []

    def fn(a):
        calls.append(a.shape[0])
        if len(calls) == 2:
            raise RuntimeError("shard 1 failed")
        return a

    with pytest.raises(RuntimeError, match="shard 1 failed"):
        auto.shard_batch_call(("fail",), fn, [np.zeros((4, 2))])


def test_spatial_policy_bounds(monkeypatch):
    small = np.zeros((1, 64, 64, 4), np.uint8)
    args = (lambda x, i0, o0, o1: x, small, 32, lambda o0, o1: (0, 64))
    monkeypatch.delenv("TIMG_TPU_DEVICES", raising=False)
    assert auto.spatial_shard_call(("t",), *args, min_pixels=1) is None
    monkeypatch.setenv("TIMG_TPU_DEVICES", "4")
    assert auto.spatial_shard_call(("t",), *args) is None   # too small
    big_batch = np.zeros((4, 64, 64, 4), np.uint8)
    assert auto.spatial_shard_call(("t",), args[0], big_batch, 32, args[3],
                                   min_pixels=1) is None   # b >= n


@pytest.mark.parametrize("b,n", [(1, 4), (2, 4), (3, 8), (1, 3)])
def test_spatial_bands_write_the_whole_frame(monkeypatch, b, n):
    """The output rows split over the cards, each band from its halo of
    input rows, join into resize_batch's bytes (a lowered threshold so
    small frames take the route)."""
    monkeypatch.setenv("TIMG_TPU_DEVICES", str(n))
    frames = _frames(4, (b, 150, 70, 4))
    frames[0, 10:40, :, 3] = 0
    frames[-1, 50:, 20:, 3] = np.arange(50, dtype=np.uint8)
    for out_h, out_w in ((37, 50), (300, 90), (150, 35)):
        got = auto.spatial_shard_call(
            ("band", out_h), lambda x, i0, o0, o1: tresize.resize_batch_rows(
                x, 150, out_h, out_w, i0, o0, o1),
            frames, out_h, lambda o0, o1: tresize.input_rows(150, out_h, o0,
                                                             o1),
            min_pixels=1)
        want = tresize.resize_batch(torch.from_numpy(frames), out_h, out_w)
        assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("in_h,out_h", [(2048, 600), (2048, 37), (600, 2048),
                                        (99, 100), (100, 99)])
def test_resize_rows_of_any_band(in_h, out_h):
    """Every output row of a band equals the whole frame's row: bands of
    one row at the edges and in the middle, and uneven thirds."""
    frames = torch.from_numpy(_frames(5, (1, in_h, 24, 4)))
    want = tresize.resize_batch(frames, out_h, 16)
    cuts = [(0, 1), (out_h - 1, out_h), (out_h // 2, out_h // 2 + 1),
            (0, out_h // 3), (out_h // 3, out_h)]
    for o0, o1 in cuts:
        i0, i1 = tresize.input_rows(in_h, out_h, o0, o1)
        got = tresize.resize_batch_rows(frames[:, i0:i1], in_h, out_h, 16,
                                        i0, o0, o1)
        assert torch.equal(got, want[:, o0:o1]), (o0, o1)


# ---------------------------------------------------------------------------
# Two cards: each wrapper's kernel launched on cuda:1
# ---------------------------------------------------------------------------

@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _kernel_calls():
    """name -> fn(device) running one wrapper on inputs made on that
    device (their kernels launch there)."""
    from timg_tpu_torch.ops import blocks as tblocks
    from timg_tpu_torch.ops import libsixel_kernel as tlib
    from timg_tpu_torch.ops import libsixel_quant as lsq
    from timg_tpu_torch.ops import sixel_dcs, sixel_runs
    from timg_tpu_torch.ops.sixel_kernel import (fs_dither_cube_rgb,
                                                 fs_dither_tree_fused,
                                                 fs_dither_tree_rgb)
    from timg_tpu_torch.ops.sixel_np import median_cut_tree
    from timg_tpu_torch.ops.sws_resize import sws_yuv420_to_rgba_words

    rng = np.random.default_rng(7)
    y = rng.integers(16, 236, (3, 270, 480), np.uint8)
    u = rng.integers(16, 240, (3, 135, 240), np.uint8)
    v = rng.integers(16, 240, (3, 135, 240), np.uint8)
    frames = _frames(8, (3, 120, 160, 4), opaque=True)
    words = frames.view(np.int32).reshape(frames.shape[:3])
    # 2160x3840 into 16x28: no fused tile fits, the two-pass route
    big = _frames(9, (1, 2160, 3840, 4), opaque=True).view(np.int32)[..., 0]
    pal, levels, leaves = median_cut_tree(frames[0, ..., :3])
    pals = [lsq.make_palette(f[..., :3])[0] for f in frames]
    pals256 = torch.from_numpy(tlib.pad_palettes(pals))
    flat = (np.arange(120 * 160).reshape(1, 120, 160) // 700 % 12).astype(
        np.uint8).repeat(3, 0)

    def t(a, dev):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def planes(dev):
        return fs_dither_cube_fused(t(words, dev), 120, 160)

    return {
        "convert": lambda d: yuv420_to_rgba_words(t(y, d), t(u, d), t(v, d),
                                                  True),
        "sws": lambda d: sws_yuv420_to_rgba_words(t(y, d), t(u, d), t(v, d),
                                                  90, 160, False),
        "resize": lambda d: tresize.resize_video_words(t(words, d), 90, 120),
        "resize_passes": lambda d: tresize.resize_video_words(t(big, d), 16,
                                                              28),
        "dither": planes,
        "tree": lambda d: fs_dither_tree_fused(
            t(words, d), torch.from_numpy(levels), torch.from_numpy(leaves),
            120, 160),
        "cube_rgb": lambda d: fs_dither_cube_rgb(t(frames, d), 120, 160),
        "tree_rgb": lambda d: fs_dither_tree_rgb(
            t(frames, d), torch.from_numpy(levels), torch.from_numpy(leaves),
            120, 160),
        "bucket": lambda d: tlib.build_bucket_tables(pals256.to(d)),
        "table": lambda d: tlib.fs_dither_table_fused(
            t(words, d), tlib.build_bucket_tables(pals256.to(d)),
            tlib.palette_words(pals256.to(d)),
            torch.ones(3, dtype=torch.int32, device=d), 120, 160),
        "quarter_cells": lambda d: tblocks.quarter_cells(t(words, d)),
        "half_cells": lambda d: tblocks.half_cells(t(words[:, 1:], d)),
        "run_counts": lambda d: sixel_runs.band_run_counts(planes(d), 120,
                                                           160),
        "compact_runs": lambda d: sixel_runs.compact_records(
            planes(d), 120, 160,
            sixel_runs.band_run_counts(planes(d), 120, 160), 4000),
        "dcs_lens": lambda d: sixel_dcs.batch_band_lens(t(flat, d), 3, 120,
                                                        160),
        "dcs_emit": lambda d: sixel_dcs.batch_encode(t(flat, d), 3, 120, 160,
                                                     4096),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["convert", "sws", "resize", "resize_passes",
                                  "dither", "tree", "cube_rgb", "tree_rgb",
                                  "bucket", "table", "quarter_cells",
                                  "half_cells", "run_counts", "compact_runs",
                                  "dcs_lens", "dcs_emit"])
def test_kernel_on_the_second_card(two_cards, name):
    """The launch runs on the tensor's card, whichever card is current:
    cuda:1's result, made while cuda:0 is current, equals cuda:0's."""
    first, second = two_cards
    call = _kernel_calls()[name]
    with torch.cuda.device(first):
        want = call(first)
        got = call(second)
    torch.cuda.synchronize(second)

    def flat(out):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return [o for o in outs if o is not None]

    for g, w in zip(flat(got), flat(want)):
        assert g.device == second and w.device == first
        assert torch.equal(g.cpu(), w.cpu())
