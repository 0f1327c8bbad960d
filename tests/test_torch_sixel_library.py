"""The library's sixel model with one median-cut palette a stream
(``adaptive`` with ``adaptive_reuse``), on the CPU, against the
benchmark's plain reference (benchmark/reference/sixel.py): byte-equal
payloads over two batches, the second reusing the first batch's tree;
the tree alone; the dither and the DCS assembly; and the front half
through ``resize_compose``, which keeps today's bytes."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

# the benchmark's packages (harness, reference), last on the path: its
# ``tests`` must not shadow this directory's
BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness.frames import make_pool  # noqa: E402
from harness.spec import traffic_mix  # noqa: E402
from reference import sixel as ref  # noqa: E402
from reference.precision import BF16  # noqa: E402

from timg_tpu_torch import models  # noqa: E402
from timg_tpu_torch.ops import sixel_np  # noqa: E402
from timg_tpu_torch.ops.compose import alpha_compose_background  # noqa: E402
from timg_tpu_torch.ops.pipeline import resize_compose  # noqa: E402
from timg_tpu_torch.ops.resize import resize_batch  # noqa: E402
from timg_tpu_torch.render import sixel_render  # noqa: E402

SEED = 2**31 + 2025
OPAQUE, CLEAR = (0, 0, 0, 255), (0, 0, 0, 0)


def film(n=8, h=96, w=160, seed=SEED):
    return make_pool(traffic_mix("batch-film")["content"], n, h, w, seed)


def model(out_h, out_w, bg):
    return models.get("sixel")(out_h=out_h, out_w=out_w, bg_color=bg,
                               dither="adaptive", adaptive_reuse=True,
                               device="cpu")


@pytest.mark.parametrize("bg", [OPAQUE, CLEAR, (30, 60, 90, 255)])
@pytest.mark.parametrize("out", [(48, 84), (50, 84), (13, 20)])
def test_two_batches_equal_the_reference(out, bg):
    frames = film()
    m = model(*out, bg)
    got = m.render_batch(frames[:4]) + m.render_batch(frames[4:])
    want = ref.payloads(list(frames), frames[0], *out, bg)
    assert got == want


def test_the_second_batch_reuses_the_first_batchs_tree():
    frames = film()
    m = model(48, 84, OPAQUE)
    m.render_batch(frames[:4])
    tree = m._quantizer
    second = m.render_batch(frames[4:])
    assert m._quantizer is tree
    own = ref.payloads(list(frames[4:]), frames[4], 48, 84, OPAQUE)
    assert second != own
    assert second == ref.payloads(list(frames[4:]), frames[0], 48, 84,
                                  OPAQUE)


def test_reset_palette_builds_the_next_batchs_tree():
    frames = film()
    m = model(48, 84, OPAQUE)
    m.render_batch(frames[:4])
    m.reset_palette()
    assert m.render_batch(frames[4:]) == ref.payloads(
        list(frames[4:]), frames[4], 48, 84, OPAQUE)


def _one_colour():
    return np.full((9, 7, 3), 77, np.uint8)


def _few_colours():
    x = np.zeros((20, 20, 3), np.uint8)
    x[5:, :, 0] = 200
    x[:, 10:, 2] = 30
    return x


def _sampled():
    # past 2^18 pixels: every second one builds the tree
    return np.random.default_rng(SEED).integers(0, 256, (600, 500, 3),
                                                dtype=np.uint8)


def _film_front():
    return ref.front(film(1)[0], 48, 84, OPAQUE)[..., :3]


@pytest.mark.parametrize("make", [_film_front, _one_colour, _few_colours,
                                  _sampled])
def test_tree_equals_the_programs(make):
    pixels = make()
    mine = ref.median_cut_tree(pixels)
    theirs = sixel_np.median_cut_tree(pixels)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_models_tree_is_the_reference_tree_of_the_first_frame():
    frames = film(4)
    m = model(48, 84, OPAQUE)
    m.render_batch(frames)
    want = ref.median_cut_tree(ref.front(frames[0], 48, 84, OPAQUE)[..., :3])
    for a, b in zip(want, m._quantizer):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("shape", [(3, 13, 20), (2, 1, 9), (1, 8, 1)])
def test_dither_equals_the_programs(shape):
    b, h, w = shape
    rng = np.random.default_rng(h * w)
    frames = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
    tree = sixel_np.median_cut_tree(frames[0, ..., :3])
    want = sixel_np.fs_dither_tree_np(frames, tree[1], tree[2])
    assert np.array_equal(ref.fs_dither_tree(frames, tree), want)


@pytest.mark.parametrize("h,w,n", [(12, 40, 256), (7, 5, 37), (1, 1, 2),
                                   (25, 300, 16)])
def test_dcs_equals_the_assemblers(h, w, n):
    rng = np.random.default_rng(h * w + n)
    idx = rng.integers(0, min(n + 3, 256), (h, w)).astype(np.uint8)
    idx[:, w // 2:] = idx[:, w // 2:w // 2 + 1]   # long runs
    palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    want = sixel_render.encode_sixel_stream_py(idx, palette)
    assert ref.dcs(idx, palette) == want
    assert sixel_render.encode_sixel_stream(idx, palette) == want


def test_bf16_reference_mismatches():
    frames = film(4)
    f32 = ref.payloads(list(frames), frames[0], 48, 84, OPAQUE)
    bf16 = ref.payloads(list(frames), frames[0], 48, 84, OPAQUE, BF16)
    assert all(a != b for a, b in zip(f32, bf16))


@pytest.mark.parametrize("bg", [OPAQUE, CLEAR, (200, 10, 10, 255)])
@pytest.mark.parametrize("out", [(48, 84), (13, 20)])
def test_resize_compose_keeps_its_bytes(out, bg):
    """``resize_compose`` through ``_resized``: the resize, then the
    compose as before, which leaves frames alone under a transparent
    background."""
    frames = torch.from_numpy(film(3))
    before = alpha_compose_background(resize_batch(frames, *out), bg,
                                      (0, 0, 0, 0))
    assert torch.equal(resize_compose(frames, *out, bg, (0, 0, 0, 0)),
                       before)


# the batch's assemblies over the pool of host threads
# (sixel_render.encode_sixel_streams): B of 1, 3 and two pools and one
MODES = {"cube": dict(dither="cube"), "a tree a frame": dict(
    dither="adaptive"), "adaptive_reuse": dict(dither="adaptive",
                                               adaptive_reuse=True),
         "render_batch_yuv": dict(dither="adaptive", adaptive_reuse=True)}
BATCHES = ["1", "3", "2w+1"]


def _batch_size(name):
    return 2 * sixel_render._host_cpus() + 1 if name == "2w+1" else int(name)


def _render(mode, b, seed=SEED):
    m = models.get("sixel")(out_h=18, out_w=30, device="cpu", **MODES[mode])
    if mode == "render_batch_yuv":
        rng = np.random.default_rng(seed % 2**32 + b)
        y = rng.integers(0, 256, (b, 30, 44), dtype=np.uint8)
        u = rng.integers(0, 256, (b, 15, 22), dtype=np.uint8)
        return m.render_batch_yuv(y, u, u[:, ::-1].copy())
    return m.render_batch(film(b, 60, 100, seed))


def _planes_seen(monkeypatch):
    """The planes the model hands to encode_sixel_streams, and what it
    returned, call by call."""
    seen = []
    fn = sixel_render.encode_sixel_streams

    def spy(planes):
        out = fn(planes)
        seen.append(([(np.array(i), np.array(p)) for i, p in planes], out))
        return out
    monkeypatch.setattr(sixel_render, "encode_sixel_streams", spy)
    return seen


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("mode", list(MODES))
def test_pooled_payloads_are_the_serial_ones_in_order(mode, batch,
                                                      monkeypatch):
    b = _batch_size(batch)
    seen = _planes_seen(monkeypatch)
    before = dict(sixel_render.ASSEMBLED)
    got = _render(mode, b)
    assert sixel_render.ASSEMBLED["c"] == before["c"] + b
    assert sixel_render.ASSEMBLED["python"] == before["python"]
    [(planes, out)] = seen
    assert out == got and len(got) == b
    assert got == [sixel_render.encode_sixel_stream(i, p)
                   for i, p in planes]
    monkeypatch.setattr(sixel_render, "_host_cpus", lambda: 1)
    assert _render(mode, b) == got


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("mode", list(MODES))
def test_python_twin_assembles_every_payload(mode, batch, monkeypatch):
    from timg_tpu_torch.native import runtime

    b = _batch_size(batch)
    want = _render(mode, b)
    before = dict(sixel_render.ASSEMBLED)
    monkeypatch.setattr(runtime, "load", lambda: None)
    assert _render(mode, b) == want
    assert sixel_render.ASSEMBLED["python"] == before["python"] + b
    assert sixel_render.ASSEMBLED["c"] == before["c"]


def test_callers_on_models_at_once_get_the_serial_bytes(monkeypatch):
    """Four callers, each on its own model, share the pool with a short
    switch interval: each gets the serial bytes, and ``ASSEMBLED``
    counts every payload."""
    import threading

    b = _batch_size("2w+1")
    modes = ["cube", "adaptive_reuse", "a tree a frame", "cube"]
    want = [_render(mode, b, SEED + k) for k, mode in enumerate(modes)]
    got = [None] * len(modes)

    def call(k):
        got[k] = _render(modes[k], b, SEED + k)

    before = sixel_render.ASSEMBLED["c"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        callers = [threading.Thread(target=call, args=(k,))
                   for k in range(len(modes))]
        for t in callers:
            t.start()
        for t in callers:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in callers)
    assert got == want
    assert sixel_render.ASSEMBLED["c"] == before + len(modes) * b


def _threads_used(monkeypatch):
    """The threads that assembled, and the most assemblies at once."""
    import threading

    used, live, lock = set(), [0, 0], threading.Lock()
    fn = sixel_render.encode_sixel_stream

    def spy(*args):
        with lock:
            used.add(threading.get_ident())
            live[0] += 1
            live[1] = max(live)
        try:
            return fn(*args)
        finally:
            with lock:
                live[0] -= 1
    monkeypatch.setattr(sixel_render, "encode_sixel_stream", spy)
    return used, live


@pytest.mark.parametrize("batch", BATCHES)
def test_width_is_at_most_the_cpus_and_the_batch(batch, monkeypatch):
    b = _batch_size(batch)
    used, live = _threads_used(monkeypatch)
    _render("cube", b)
    width = min(sixel_render._host_cpus(), b)
    assert 1 <= len(used) <= width and live[1] <= width
    pool = sixel_render._pool
    assert pool is None or pool._max_workers <= sixel_render._host_cpus()


@pytest.mark.parametrize("mode", list(MODES))
def test_a_batch_of_one_starts_no_thread(mode, monkeypatch):
    import threading

    monkeypatch.setattr(sixel_render, "_pool", None)
    used, _ = _threads_used(monkeypatch)
    threads = threading.active_count()
    assert len(_render(mode, 1)) == 1
    assert used == {threading.get_ident()}
    assert sixel_render._pool is None
    assert threading.active_count() == threads
