"""The least time an H100 could take for a kernel's work, and the
operations and bytes each kernel's algorithm needs for the given inputs.

Peaks (NVIDIA's H100 SXM data sheet, at the full 700 W limit):
3.35 TB/s of HBM; float32 instructions outside the tensor cores 132 SMs
x 128 lanes x 1.98 GHz = 33.45 T/s (the sheet's 67 TFLOP/s counts an FMA
as two; the kernels contract no product and sum, so one counted
operation is one instruction); integer operations half that rate.
Bytes: every input byte read once and every output byte written once,
whatever a kernel reads again.  The peaks are chip_smoke.py's, and
benchmark/tests hold them equal.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 132 * 128 * 1.98e9


def bound_s(nbytes: float, nops: float, ops_per_s: float = F32_OPS_PER_S):
    """(seconds, "bytes" | "operations"): the larger of the two times."""
    tb, to = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    return (tb, "bytes") if tb >= to else (to, "operations")


def stb_resize_compose(frames: int, in_h: int, in_w: int, out_h: int,
                       out_w: int, taps_h: int, taps_w: int,
                       vertical_first: bool):
    """(bytes, operations) of the stb resize with its alpha weighting
    and the compose over an opaque background, for ``frames`` RGBA
    frames.  Bytes: the RGBA frames in, the composed frames out.
    Operations, a channel of the 7 the weighting filters (RGBA and the
    premultiplied RGB): decode 1 and the premultiply (3 of 7) an input
    pixel; a product and a sum a tap in each pass; the un-weighting 5
    and the encode 3 a channel of 4 an output pixel; the compose 12 an
    output pixel (3 squares, 3 products by alpha, 3 by the background's
    weight, 3 sums and the weight) and its exact root, 8 bisection
    steps of 3 on 3 channels."""
    px_in, px_out = in_h * in_w, out_h * out_w
    mid = out_h * in_w if vertical_first else in_h * out_w
    first, second = (taps_h, taps_w) if vertical_first else (taps_w, taps_h)
    ops = (px_in * (4 + 3)
           + 7 * 2 * (mid * first + px_out * second)
           + px_out * (5 + 4 * 3)
           + px_out * (12 + 8 * 3 * 3))
    return frames * 4 * (px_in + px_out), frames * ops


def share_pct(bound: float, device_s: float):
    """The roofline share in percent, or None without device time."""
    if device_s <= 0:
        return None
    return 100.0 * bound / device_s
