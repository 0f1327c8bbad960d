"""The library API's staging of a host batch (timg_tpu_torch/ops/staging.py):
the chunk plan of the pinned ring, the CPU passthroughs, and, on a card,
the ring's bytes against the pageable route's.

Imports no jax, so it runs on a GPU machine without the JAX package:

    python -m pytest tests/test_torch_staging.py -m cuda

Tests marked ``cuda`` need a card and skip without one.  On the card
they hold the ring's payloads byte-equal to those of a pageable
``.to(device)`` and of the port on the CPU, which
tests/test_torch_models.py holds byte-equal to the JAX package's models.
Tolerance everywhere: byte equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from timg_tpu_torch import models, tracing  # noqa: E402
from timg_tpu_torch.ops import staging  # noqa: E402

FRAME_1080P = 1080 * 1920 * 4


def _frames(seed, b, h=36, w=52):
    rng = np.random.default_rng(seed)
    fr = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
    fr[..., 3] = rng.choice(np.array([0, 7, 128, 255, 255], np.uint8),
                            size=(b, h, w))
    return fr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.fixture
def small_slots(monkeypatch):
    """Slots of two small frames, so that a small batch takes many
    chunks and both slots are reused within a batch."""
    frame = _frames(0, 1)[0].nbytes
    monkeypatch.setattr(staging, "SLOT_BYTES", 2 * frame)
    return frame


@pytest.mark.parametrize("frame_nbytes,k", [
    (FRAME_1080P, 4),                    # 1080p RGBA: 4 frames a slot
    (staging.SLOT_BYTES, 1),             # exactly one slot
    (staging.SLOT_BYTES + 1, 1),         # past a slot: still one frame
    (3840 * 2160 * 4 * 2, 1),
    (1, staging.SLOT_BYTES),
    (0, staging.SLOT_BYTES),
])
def test_chunk_frames(frame_nbytes, k):
    assert staging.chunk_frames(frame_nbytes) == k


@pytest.mark.parametrize("b,sizes", [
    (1, [1]), (3, [3]), (32, [4] * 8), (33, [4] * 8 + [1])])
def test_chunks_cover_the_batch_in_alternate_slots(b, sizes):
    plan = staging.chunks(b, FRAME_1080P)
    assert [n for _, _, n in plan] == sizes
    assert [s for s, _, _ in plan] == [c % 2 for c in range(len(plan))]
    assert [i for _, i, _ in plan] == list(np.cumsum([0] + sizes[:-1]))


def test_chunks_of_frames_past_a_slot():
    big = staging.SLOT_BYTES + 1
    assert staging.chunks(3, big) == [(0, 0, 1), (1, 1, 1), (0, 2, 1)]


def test_cpu_tensor_passes_through():
    ring = staging.Ring(torch.device("cpu"))
    t = torch.from_numpy(_frames(1, 3))
    assert ring.to_device(t) is t
    assert ring._stream is None and not ring._slots


def test_cpu_numpy_is_not_copied():
    ring = staging.Ring(torch.device("cpu"))
    fr = _frames(2, 3)
    out = ring.to_device(fr)
    assert np.shares_memory(out.numpy(), fr)
    assert ring._stream is None and not ring._slots


@pytest.mark.parametrize("view", [
    lambda a: a[:, ::2],                  # rows strided
    lambda a: a[:, :, ::-1],              # columns reversed
    lambda a: a[::-1],                    # frames reversed
    lambda a: a.transpose(0, 2, 1, 3),    # transposed
])
def test_strided_numpy_equals_its_contiguous_copy(view):
    fr = view(_frames(3, 4))
    want = np.ascontiguousarray(fr)
    out = staging.Ring(torch.device("cpu")).to_device(fr)
    assert out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), want)
    model = models.get("quarter")(out_h=10, out_w=20, device="cpu")
    assert model.render_batch(fr) == model.render_batch(want)


def test_list_of_frames_is_stacked():
    fr = _frames(4, 3)
    out = staging.Ring(torch.device("cpu")).to_device(list(fr))
    np.testing.assert_array_equal(out.numpy(), fr)


# --- on the card ----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 32, 33])
@pytest.mark.parametrize("name", ["quarter", "half"])
def test_ring_payloads_equal_pageable_and_cpu(cuda_device, small_slots,
                                              name, b):
    fr = _frames(10 + b, b)
    kw = dict(out_h=12, out_w=20, bg_color=(40, 90, 200, 255))
    model = models.get(name)(device=cuda_device, **kw)
    ring = model.render_batch(fr)
    pageable = model.render_batch(torch.from_numpy(fr).to(cuda_device))
    cpu = models.get(name)(device="cpu", **kw).render_batch(fr)
    assert ring == pageable == cpu and len(ring) == b
    assert len(model._staging._slots) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 32, 33])
def test_ring_at_1080p_equals_the_frames(cuda_device, b):
    fr = np.random.default_rng(b).integers(0, 256, (b, 1080, 1920, 4),
                                           dtype=np.uint8)
    ring = staging.Ring(cuda_device)
    out = ring.to_device(fr)
    assert out.device.type == "cuda"
    assert torch.equal(out.cpu(), torch.from_numpy(fr))
    assert ring._slots[0].numel() == 4 * FRAME_1080P
    assert all(s.is_pinned() for s in ring._slots)


@pytest.mark.cuda
def test_back_to_back_batches_keep_their_bytes(cuda_device, small_slots):
    """Batches staged one after another with no wait between them: a
    slot repacked before its DMA ended would show in an earlier batch."""
    ring = staging.Ring(cuda_device)
    batches = [_frames(20 + i, b) for i, b in enumerate([5, 1, 8, 3, 7])]
    outs = [ring.to_device(fr) for fr in batches]
    for fr, out in zip(batches, outs):
        np.testing.assert_array_equal(out.cpu().numpy(), fr)


@pytest.mark.cuda
def test_caller_may_overwrite_its_batch_at_once(cuda_device, small_slots):
    ring = staging.Ring(cuda_device)
    fr = _frames(30, 9)
    want = fr.copy()
    out = ring.to_device(fr)
    fr[:] = 0
    np.testing.assert_array_equal(out.cpu().numpy(), want)
    model = models.get("quarter")(out_h=12, out_w=20, device=cuda_device)
    fr = want.copy()
    payloads = model.render_batch(fr)
    fr[:] = 255
    assert payloads == model.render_batch(want)


@pytest.mark.cuda
def test_pinned_and_device_tensors(cuda_device, small_slots):
    ring = staging.Ring(cuda_device)
    fr = _frames(40, 5)
    pinned = torch.from_numpy(fr).pin_memory()
    out = ring.to_device(pinned)
    assert not ring._slots                   # one copy, no slot
    np.testing.assert_array_equal(out.cpu().numpy(), fr)
    on_card = torch.from_numpy(fr).to(cuda_device)
    assert ring.to_device(on_card) is on_card
    strided = torch.from_numpy(fr).pin_memory()[:, ::2]
    np.testing.assert_array_equal(ring.to_device(strided).cpu().numpy(),
                                  fr[:, ::2])
    assert ring._slots                       # a strided one packs


@pytest.mark.cuda
def test_pixel_model_stages_through_the_ring(cuda_device, small_slots):
    rng = np.random.default_rng(50)
    y = rng.integers(0, 256, (5, 36, 52), dtype=np.uint8)
    u = rng.integers(0, 256, (5, 18, 26), dtype=np.uint8)
    model = models.get("kitty")(out_h=12, out_w=20, device=cuda_device)
    for plane in (y, u, y[:, ::-1]):
        np.testing.assert_array_equal(
            model._to_device(plane).cpu().numpy(), plane)
    assert model._staging._slots
    fr = _frames(51, 5)
    assert model.render_batch(fr) == model.render_batch(
        torch.from_numpy(fr).to(cuda_device))


@pytest.mark.cuda
def test_second_card_equals_the_first(small_slots):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    fr = _frames(60, 7)
    out = [models.get("quarter")(out_h=12, out_w=20,
                                 device=f"cuda:{i}").render_batch(fr)
           for i in (0, 1)]
    assert out[0] == out[1]
    ring = staging.Ring(torch.device("cuda:1"))
    staged = ring.to_device(fr)
    assert staged.device == torch.device("cuda:1")
    np.testing.assert_array_equal(staged.cpu().numpy(), fr)


@pytest.mark.cuda
def test_pin_spans_nest_in_the_stage_span(cuda_device, small_slots):
    fr = _frames(70, 7)
    model = models.get("quarter")(out_h=12, out_w=20, device=cuda_device)
    tracing.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            model.render_batch(fr)
        recs = tracing.records()
    finally:
        tracing.clear()
    stage = [r for r in recs if r.name == "lib.stage"]
    pins = [r for r in recs if r.name == "lib.pin"]
    assert len(stage) == 1 and stage[0].count == fr.nbytes
    assert len(pins) == 4                    # chunks of 2, 2, 2 and 1
    assert all(p.parent_id == stage[0].span_id for p in pins)
    assert all(stage[0].t0_ns <= p.t0_ns <= p.t1_ns <= stage[0].t1_ns
               for p in pins)
    assert sum(p.count for p in pins) == fr.nbytes
