"""The traffic's frames, made from the seed: the one general generator.

A traffic file names a generator and its parameters under ``content``;
``make_pool`` makes a pool of distinct decoded frames that a run cycles
through: [H, W, 4] RGBA frames, as a library caller hands them to a
model.  Every seed gives the same sizes, the same statistics and the
same amount of work; only the noise and the phase of the motion differ.

The pattern follows chip_smoke.py's ``rgba_frames``, made in bulk here.
"""

from __future__ import annotations

import numpy as np


def _uniform(rng, shape, top: int) -> np.ndarray:
    """uint8 noise over 0 .. top - 1 (top <= 256) for ``shape`` =
    (n, ...): one frame's worth drawn from the generator plus a stride a
    frame, frame i reading it from offset i * stride, so every frame's
    noise differs at the cost of one frame's draw."""
    n, size = shape[0], int(np.prod(shape[1:]))
    stride = 7919
    count = size + n * stride
    raw = rng.integers(0, 1 << 32, -(-count // 4), dtype=np.uint32)
    raw = raw.view(np.uint8)[:count]
    if top < 256:
        raw = ((raw.astype(np.uint16) * top) >> 8).astype(np.uint8)
    view = np.lib.stride_tricks.as_strided(
        raw, (n, size), (stride, 1), writeable=False)
    return view.reshape(shape)


def film_rgba(n: int, h: int, w: int, rng, *, grain: int = 32,
              box=(0.5, 1 / 3), box_step=(3, 5)):
    """Film-like RGBA: channel gradients moving a step a frame plus grain
    of 0..grain, opaque but for a box of h box[0] x w box[1] whose alpha
    falls from 254 to 0 left to right, moving box_step pixels a frame."""
    out = np.empty((n, h, w, 4), np.uint8)
    xx = np.arange(w, dtype=np.int32)[None, :]
    yy = np.arange(h, dtype=np.int32)[:, None]
    grads = np.stack([(xx * (60 + 50 * c) // w + yy * (90 - 20 * c) // h
                       + 40 * c) % 256 for c in range(3)]
                     + [np.zeros((h, w), np.int32)], -1).astype(np.uint8)
    phase = int(rng.integers(0, 256))
    bh, bw = int(h * box[0]), int(w * box[1])
    ramp = np.linspace(254, 0, bw).astype(np.uint8)
    shift = ((phase + 23 * np.arange(n)) % 256).astype(np.uint8)
    noise = _uniform(rng, (n, h, w, 4), grain)
    for i in range(n):
        np.add(grads, noise[i], out=out[i])       # uint8: wraps mod 256
        out[i] += shift[i]
        out[i, ..., 3] = 255
        y0 = (h // 6 + box_step[0] * i) % max(h - bh, 1)
        x0 = (w // 6 + box_step[1] * i) % max(w - bw, 1)
        out[i, y0:y0 + bh, x0:x0 + bw, 3] = ramp[None, :]
    return out


GENERATORS = {"film_rgba": film_rgba}


def make_pool(content: dict, n: int, h: int, w: int, seed: int):
    """The traffic's ``content`` ({"generator": name, ...parameters}) as
    ``n`` frames of h x w: an [n, h, w, 4] RGBA stack."""
    params = dict(content)
    gen = GENERATORS[params.pop("generator")]
    return gen(n, h, w, np.random.default_rng(seed), **params)
