"""stb_resize_roofline: the bound of the library's stb resize and
compose (harness/roofline.py) for the payloads asked for, over the
device seconds of the kernels launched inside the profiler range that
wraps ops/pipeline.py _resized (resize and compose)."""

from harness import roofline

SPANS = {"stb_resize": ["timg_tpu_torch.ops.pipeline:_resized"]}
RANGES = ("stb_resize",)


def read(r):
    from reference.stb_taps import (STB_DOWNSAMPLE_FILTER,
                                    STB_UPSAMPLE_FILTER, packed_taps,
                                    plan_passes)

    if r.trace is None or r.frames == 0:
        return None
    device_s = r.trace.ranges.get("stb_resize", 0.0)
    if device_s <= 0:
        return None
    cfg = r.run.config
    in_h, in_w = int(cfg["frames"]["height"]), int(cfg["frames"]["width"])
    oh, ow = int(cfg["out_h"]), int(cfg["out_w"])
    up, down = STB_UPSAMPLE_FILTER, STB_DOWNSAMPLE_FILTER
    taps_h = packed_taps(in_h, oh, up, down, False)[1].shape[1]
    taps_w = packed_taps(in_w, ow, up, down, True)[1].shape[1]
    work = roofline.stb_resize_compose(
        r.frames, in_h, in_w, oh, ow, taps_h, taps_w,
        plan_passes(in_h, in_w, oh, ow, up, down, True))
    return roofline.share_pct(roofline.bound_s(*work)[0], device_s)
