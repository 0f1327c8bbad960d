"""The plain reference against the program's plain PyTorch versions (the
CPU path, held byte-equal to the CUDA kernels by the port's own tests)
on a few seeded frames of the traffic mix."""

import numpy as np
import pytest
import torch

from harness.frames import make_pool
from harness.spec import traffic_mix
from reference import cells, encode, pixels, streams

SEED = 2**31 + 1234


def rgba_frames(h=216, w=384, n=2):
    return make_pool(traffic_mix("batch-film")["content"], n, h, w, SEED)


def program_pixels(frames, out):
    from timg_tpu_torch.ops.compose import alpha_compose_background
    from timg_tpu_torch.ops.resize import resize_batch

    x = resize_batch(torch.from_numpy(frames), *out)
    return x, alpha_compose_background(x, (0, 0, 0, 255), (0, 0, 0, 0))


@pytest.mark.parametrize("out", [(10, 32), (90, 320)])
def test_stb_resize_and_compose(out):
    frames = rgba_frames()
    x, composed = program_pixels(frames, out)
    for i in range(len(frames)):
        mine = pixels.stb_resize(frames[i], *out)
        assert np.array_equal(mine, x[i].numpy())
        assert np.array_equal(pixels.compose_background(mine, (0, 0, 0, 255)),
                              composed[i].numpy())


@pytest.mark.parametrize("out", [(10, 32), (90, 320)])
def test_quarter_cells_and_emit(out):
    from timg_tpu_torch.ops.blocks import quarter_cells_plain
    from timg_tpu_torch.render.ansi import UnicodeBlockCanvas

    frames = rgba_frames()
    _, composed = program_pixels(frames, out)
    words = composed.contiguous().view(torch.int32).reshape(
        len(frames), *out)
    glyph, fg, bg, _ = quarter_cells_plain(words)
    canvas = UnicodeBlockCanvas.__new__(UnicodeBlockCanvas)
    canvas.use_256_color = False
    for i in range(len(frames)):
        g, f, b = cells.quarter_cells(composed[i].numpy())
        assert np.array_equal(g, glyph[i].numpy())
        assert np.array_equal(f, fg[i].numpy().view(np.uint8)
                              .reshape(f.shape))
        assert np.array_equal(b, bg[i].numpy().view(np.uint8)
                              .reshape(b.shape))
        assert encode.ansi_blocks(g, f, b) == \
            canvas._emit_frame_py(g, f, b, None, 0)


def test_payload_is_the_models(cpu_device):
    from timg_tpu_torch import models

    frames = rgba_frames(n=3)
    model = models.get("quarter")(out_h=10, out_w=32,
                                  bg_color=(0, 0, 0, 255))
    got = model.render_batch(frames)
    for i in range(len(frames)):
        assert streams.library_quarter_payload(
            frames[i], 10, 32, (0, 0, 0, 255)) == got[i]
