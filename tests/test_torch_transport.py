"""The port's device->host transports (timg_tpu_torch/ops/sixel_runs.py,
ops/sixel_dcs.py) against the JAX package's.

Seeded index planes (noise, flat, vertical bars, h % 6 != 0, odd w,
row-3 values >= 128 for the int32 sign wrap, a band of more than 64
colours, a plane larger than its valid region) go through the port's
plain run counts, run compaction, DCS band lengths and DCS emission and
through the JAX package's device ops on XLA:CPU and its numpy mirrors:
records up to each frame's count, band counts, lengths and band bytes
must be equal.  The port's splice of its bands and its records
assembler must write the C assembler's stream of the plane;
``fetch_planes_or_runs`` must pick the JAX package's transport with the
same STATS in every mode; and the CLI's -ps stream and its --verbose
transport line must equal the JAX CLI's under every
TIMG_TPU_SIXEL_TRANSPORT, in every dither mode.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

import jax.numpy as jnp  # noqa: E402

from timg_tpu.ops import sixel_dcs as jax_dcs  # noqa: E402
from timg_tpu.ops import sixel_runs as jax_runs  # noqa: E402
from timg_tpu_torch.ops import sixel_dcs, sixel_runs  # noqa: E402


def _planes(name):
    """[B, H, W] uint8 planes and the valid (h, w) of each case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "noise":
        return rng.integers(0, 256, (2, 30, 33), np.uint8), 30, 33
    if name == "flat":
        p = np.zeros((2, 36, 40), np.uint8)
        p[:, :, 10:20] = 3
        p[:, 7:20, 25:] = 250
        p[1] = 17
        return p, 36, 40
    if name == "bars":
        p = np.zeros((2, 18, 50), np.uint8)
        p[:, :, ::2] = 7
        p[:, :, 1::4] = 200
        return p, 18, 50
    if name == "partial-band":
        return rng.integers(0, 8, (3, 23, 17), np.uint8), 23, 17
    if name == "odd-width":
        return rng.integers(0, 4, (2, 13, 31), np.uint8), 13, 31
    if name == "sign-wrap":       # rows 3 (and all) >= 128
        return rng.integers(128, 256, (2, 12, 20), np.uint8), 12, 20
    if name == "many-colours":   # one band of 96 colours, one of 3
        p = rng.integers(0, 3, (2, 12, 96), np.uint8)
        p[:, :6] = np.arange(96, dtype=np.uint8)[None, None] + 100
        return p, 12, 96
    if name == "padded":
        return rng.integers(0, 16, (2, 64, 128), np.uint8), 18, 40
    if name == "one-row":
        return rng.integers(0, 5, (2, 1, 9), np.uint8), 1, 9
    if name == "long-runs":      # runs of 1,000+ columns: 4 length digits
        p = np.full((2, 7, 1500), 9, np.uint8)
        p[:, 3, 700:] = 12
        p[1, :, :5] = 1
        return p, 7, 1500
    raise KeyError(name)


CASES = ["noise", "flat", "bars", "partial-band", "odd-width", "sign-wrap",
         "many-colours", "padded", "one-row", "long-runs"]


@pytest.mark.parametrize("name", CASES)
def test_run_counts_and_records_match_jax_and_numpy(name):
    planes, h, w = _planes(name)
    cap = sixel_runs.default_cap(h, w)
    t = torch.from_numpy(planes)
    counts = sixel_runs.run_counts(t, h, w).numpy()
    want = np.asarray(jax_runs.run_counts_jit(jnp.asarray(planes), h, w))
    np.testing.assert_array_equal(counts, want)
    records, band_counts = sixel_runs.compact_runs(t, h, w, cap)
    jrec, jbc = jax_runs.compact_runs_jit(jnp.asarray(planes), h, w, cap)
    jrec, jbc = np.asarray(jrec), np.asarray(jbc)
    assert records.shape == jrec.shape
    np.testing.assert_array_equal(band_counts.numpy(), jbc)
    np.testing.assert_array_equal(
        sixel_runs.band_run_counts(t, h, w).numpy(), jbc)
    for i in range(len(planes)):
        n = int(counts[i])
        got = records[i].numpy()
        np.testing.assert_array_equal(got[:n], jrec[i, :n])
        assert not got[n:].any()
        ref = sixel_runs.compact_runs_np(planes[i], h, w)
        np.testing.assert_array_equal(got[:n], ref.records)
        np.testing.assert_array_equal(ref.band_counts, jbc[i])
        runs = sixel_runs.SixelRuns(got[:n], band_counts[i].numpy(), h, w)
        np.testing.assert_array_equal(sixel_runs.expand_runs_np(runs),
                                      planes[i, :h, :w])


def test_compact_runs_truncates_at_cap_as_jax():
    planes, h, w = _planes("noise")
    cap = 64
    records, band_counts = sixel_runs.compact_runs(torch.from_numpy(planes),
                                                   h, w, cap)
    jrec, jbc = jax_runs.compact_runs_jit(jnp.asarray(planes), h, w, cap)
    assert records.shape == (2, cap, 2)
    np.testing.assert_array_equal(records.numpy(), np.asarray(jrec))
    np.testing.assert_array_equal(band_counts.numpy(), np.asarray(jbc))


@pytest.mark.parametrize("name", CASES)
def test_dcs_lens_and_bands_match_jax_and_numpy(name):
    planes, h, w = _planes(name)
    b = len(planes)
    t = torch.from_numpy(planes)
    lens, counts = sixel_dcs.batch_band_lens(t, b, h, w)
    jl, jc = jax_dcs.batch_band_lens(jnp.asarray(planes), b, h, w)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    cap = sixel_dcs.bucket_cap(int(lens.max()))
    assert cap == jax_dcs.bucket_cap(int(np.asarray(jl).max()))
    bands, lens2 = sixel_dcs.batch_encode(t, b, h, w, cap)
    jb, jl2 = jax_dcs.batch_encode(jnp.asarray(planes), b, h, w, cap)
    np.testing.assert_array_equal(bands.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(lens2.numpy(), np.asarray(jl2))
    for i in range(b):
        ref, ref_lens, overflow = sixel_dcs.encode_np(planes[i], h, w, 256)
        assert overflow == bool((counts[i] > sixel_dcs.COLOR_CAP).any())
        if not overflow:
            np.testing.assert_array_equal(lens[i].numpy(), ref_lens)
            for k, n in enumerate(ref_lens):
                assert bytes(bands[i, k, :n].numpy()) == bytes(ref[k, :n])


def _palette(n=256):
    return np.random.default_rng(5).integers(0, 256, (n, 3), np.uint8)


@pytest.mark.parametrize("name", CASES)
def test_splice_and_records_assembler_write_the_plane_stream(name):
    """The port's splice of its DCS bands (of frames of at most 64
    colours a band) and its C records assembler write the C assembler's
    stream of the plane."""
    from timg_tpu_torch.native import runtime
    from timg_tpu_torch.render import sixel_render

    if runtime.load() is None:
        pytest.skip("the port's native helper did not build")
    planes, h, w = _planes(name)
    t = torch.from_numpy(planes)
    pal = _palette()
    lens, colours = sixel_dcs.batch_band_lens(t, len(planes), h, w)
    bands, lens = sixel_dcs.batch_encode(
        t, len(planes), h, w, sixel_dcs.bucket_cap(int(lens.max())))
    records, band_counts = sixel_runs.compact_runs(
        t, h, w, sixel_runs.default_cap(h, w))
    for i in range(len(planes)):
        want = sixel_render.encode_sixel_stream(
            np.ascontiguousarray(planes[i, :h, :w]), pal)
        dcs = sixel_dcs.SixelDcs(bands[i].numpy(), lens[i].numpy(), h, w)
        if colours[i].max() <= sixel_dcs.COLOR_CAP:
            assert sixel_render.encode_sixel_stream_dcs(dcs, pal) == want
        n = int(band_counts[i].sum())
        runs = sixel_runs.SixelRuns(records[i, :n].numpy(),
                                    band_counts[i].numpy(), h, w)
        assert sixel_render.encode_sixel_stream_runs(runs, pal) == want


def _transport_planes(kind):
    """Windows that each transport carries: flat (runs), a checkerboard
    (DCS: every column its own run, 2 colours a band), noise (plane)."""
    b, h, w = 2, 60, 400
    if kind == "flat":
        p = np.zeros((b, h, w), np.uint8)
        p[:, 20:, 100:] = 5
        return p, h, w
    if kind == "checker":
        base = (np.add.outer(np.arange(h), np.arange(w)) % 2).astype(
            np.uint8)
        return np.stack([base ^ (i % 2) for i in range(b)]), h, w
    return np.random.default_rng(3).integers(0, 256, (b, h, w),
                                             np.uint8), h, w


def _entry_kind(e):
    return type(e).__name__ if not isinstance(e, np.ndarray) else "plane"


@pytest.mark.parametrize("mode,verdict", [
    ("plane", None), ("runs", None), ("dcs", None), ("auto", None),
    ("auto", True), ("auto", False), ("bogus", False)])
@pytest.mark.parametrize("kind", ["flat", "checker", "noise"])
def test_fetch_matches_jax_transport_and_stats(monkeypatch, mode, verdict,
                                               kind):
    """Each TIMG_TPU_SIXEL_TRANSPORT mode, with the auto verdict reset
    (None: the race decides in both packages, which may disagree, so
    only each side's consistency is held) or pinned, in both packages:
    the same entry types and STATS deltas, and each entry's stream is
    the plane's."""
    from timg_tpu_torch.render import sixel_render

    planes, h, w = _transport_planes(kind)
    monkeypatch.setenv("TIMG_TPU_SIXEL_TRANSPORT", mode)
    monkeypatch.setattr(sixel_runs, "_DCS_FASTER", verdict)
    monkeypatch.setattr(jax_runs, "_DCS_FASTER", verdict)
    s0, j0 = dict(sixel_runs.STATS), dict(jax_runs.STATS)
    got = sixel_runs.fetch_planes_or_runs(torch.from_numpy(planes),
                                          len(planes), h, w)
    want = jax_runs.fetch_planes_or_runs(jnp.asarray(planes), len(planes),
                                         h, w)
    ds = {k: sixel_runs.STATS[k] - s0[k] for k in s0}
    dj = {k: jax_runs.STATS[k] - j0[k] for k in j0}
    kinds = [_entry_kind(e) for e in got]
    if mode == "auto" and verdict is None and "SixelDcs" in (
            kinds + [_entry_kind(e) for e in want]):
        # the race's outcome is each package's own
        assert sixel_runs._DCS_FASTER in (True, False)
        assert (kinds[0] == "SixelDcs") == sixel_runs._DCS_FASTER
    else:
        assert kinds == [_entry_kind(e) for e in want]
        assert ds == dj
    assert sum(ds[k] for k in ("frames_runs", "frames_plane",
                               "frames_dcs")) == len(planes)
    pal = _palette(8)
    encoders = {"plane": sixel_render.encode_sixel_stream,
                "SixelRuns": sixel_render.encode_sixel_stream_runs,
                "SixelDcs": sixel_render.encode_sixel_stream_dcs}
    for i, e in enumerate(got):
        assert encoders[_entry_kind(e)](e, pal) == \
            sixel_render.encode_sixel_stream(planes[i], pal)
    expect = {("runs", "flat"): "SixelRuns", ("dcs", "checker"): "SixelDcs",
              ("plane", "flat"): "plane", ("dcs", "noise"): "plane"}
    if (mode, kind) in expect:
        assert kinds == [expect[mode, kind]] * len(planes)


@pytest.mark.parametrize("mode", ["runs", "auto"])
@pytest.mark.parametrize("kind", ["flat", "checker", "noise", "bars"])
def test_fetch_counts_once_a_window(monkeypatch, mode, kind):
    """The runs leg launches the counts once a window: in runs and auto
    mode (the DCS verdict pinned False in both packages)
    fetch_planes_or_runs calls band_run_counts once and, where it ships
    runs, compact_records once, with those counts and n = the JAX
    package's slice length (min(keep, nb * w); bars: nb * w); never
    run_counts or compact_runs.  Its entries and STATS equal the JAX
    package's."""
    planes, h, w = (_planes(kind) if kind == "bars"
                    else _transport_planes(kind))
    b, nb = len(planes), (h + 5) // 6
    calls = {"counts": [], "records": []}
    counts_fn = sixel_runs.band_run_counts
    records_fn = sixel_runs.compact_records

    def counts_once(p, hh, ww):
        calls["counts"].append(counts_fn(p, hh, ww))
        return calls["counts"][-1]

    def records_once(p, hh, ww, counts, n):
        calls["records"].append((counts, n))
        return records_fn(p, hh, ww, counts, n)

    def refused(*args):
        raise AssertionError("the runs leg recounts")

    monkeypatch.setenv("TIMG_TPU_SIXEL_TRANSPORT", mode)
    monkeypatch.setattr(sixel_runs, "_DCS_FASTER", False)
    monkeypatch.setattr(jax_runs, "_DCS_FASTER", False)
    monkeypatch.setattr(sixel_runs, "band_run_counts", counts_once)
    monkeypatch.setattr(sixel_runs, "compact_records", records_once)
    monkeypatch.setattr(sixel_runs, "run_counts", refused)
    monkeypatch.setattr(sixel_runs, "compact_runs", refused)
    s0, j0 = dict(sixel_runs.STATS), dict(jax_runs.STATS)
    got = sixel_runs.fetch_planes_or_runs(torch.from_numpy(planes), b, h, w)
    want = jax_runs.fetch_planes_or_runs(jnp.asarray(planes), b, h, w)
    ds = {k: sixel_runs.STATS[k] - s0[k] for k in s0}
    dj = {k: jax_runs.STATS[k] - j0[k] for k in j0}
    assert ds == dj
    assert [_entry_kind(e) for e in got] == [_entry_kind(e) for e in want]
    for g, x in zip(got, want):
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, x)
        else:
            np.testing.assert_array_equal(g.records, x.records)
            np.testing.assert_array_equal(g.band_counts, x.band_counts)
    assert len(calls["counts"]) == 1
    runs = ds["frames_runs"] == b
    assert len(calls["records"]) == runs
    if runs:
        counts, n = calls["records"][0]
        assert counts is calls["counts"][0]
        assert ds["bytes_shipped"] == 8 * b * n + 4 * b * nb
        assert n == (nb * w if kind == "bars" else 128)
    assert runs == (kind == "flat" or (kind, mode) == ("bars", "runs"))


TRANSPORT_LINE = re.compile(rb"Device->host sixel transport:[^\n]*")


def _flat_y4m(tmp_path, w=64, h=48, n=5):
    """Black and white areas (limited-range Y 16 and 235, neutral
    chroma: palette colours in every dither mode, so no dither error)
    whose boundary moves: runs compress, and a band holds 2 colours."""
    p = tmp_path / "flat.y4m"
    with open(p, "wb") as f:
        f.write(("YUV4MPEG2 W%d H%d F25:1 Ip A1:1 C420jpeg\n"
                 % (w, h)).encode())
        ch, cw = (h + 1) // 2, (w + 1) // 2
        for i in range(n):
            y = np.full((h, w), 16, np.uint8)
            y[:, 8 * i + 8:] = 235
            f.write(b"FRAME\n" + y.tobytes()
                    + np.full((2, ch, cw), 128, np.uint8).tobytes())
    return str(p)


@pytest.mark.parametrize("clip", ["flat", "noisy"])
@pytest.mark.parametrize("dither", ["cube", "libsixel", "adaptive"])
@pytest.mark.parametrize("mode,verdict", [
    ("plane", None), ("runs", None), ("dcs", None), ("auto", True),
    ("auto", False)])
def test_cli_stream_and_transport_line_match_jax(tmp_path, monkeypatch,
                                                 capfd, dither, mode,
                                                 verdict, clip):
    """-ps video under each TIMG_TPU_SIXEL_TRANSPORT (auto with the
    session verdict pinned in both packages), on a flat clip that every
    transport carries and on the CLI tests' noisy clip: the port's
    stream and its --verbose transport line equal the JAX CLI's on its
    device window; on the flat clip the forced modes move their own
    frames."""
    from tests.test_torch_cli import _run_pty, _y4m
    from timg_tpu.cli import main as jax_main
    from timg_tpu.native import runtime as jax_runtime
    from timg_tpu_torch.cli import main as torch_main

    if jax_runtime.load() is None:
        pytest.skip("native video helper unavailable")
    monkeypatch.setenv("TIMG_TPU_FORCE_DEVICE", "1")
    monkeypatch.setenv("TIMG_TPU_VIDEO_DEVICE_WINDOW", "1")
    monkeypatch.setenv("TIMG_TPU_SIXEL_TRANSPORT", mode)
    monkeypatch.setattr(sixel_runs, "_DCS_FASTER", verdict)
    monkeypatch.setattr(jax_runs, "_DCS_FASTER", verdict)
    path = _flat_y4m(tmp_path) if clip == "flat" else _y4m(tmp_path)
    argv = ["--debug-no-frame-delay", "-g40x20", "-ps", f"--dither={dither}",
            "-b", "black", "--loops=1", "--verbose", path]
    capfd.readouterr()
    j0 = dict(jax_runs.STATS)
    want = _run_pty(jax_main, argv, tmp_path / "jax.out")
    want_err = capfd.readouterr().err.encode()
    s0 = dict(sixel_runs.STATS)
    got = _run_pty(torch_main, argv, tmp_path / "torch.out")
    got_err = capfd.readouterr().err.encode()
    assert got == want
    assert got.count(b"\033Pq") == 5
    assert TRANSPORT_LINE.findall(got_err) == TRANSPORT_LINE.findall(want_err)
    ds = {k: sixel_runs.STATS[k] - s0[k] for k in s0}
    dj = {k: jax_runs.STATS[k] - j0[k] for k in j0}
    assert ds == dj
    moved = {"plane": "frames_plane", "runs": "frames_runs",
             "dcs": "frames_dcs"}.get(mode)
    if moved and clip == "flat":
        assert ds[moved] == 5
