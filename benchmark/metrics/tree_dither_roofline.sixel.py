"""tree_dither_roofline.sixel: the least time an H100 could take for the
tree dither of the payloads asked for inside the traced window, over the
device seconds of the kernels that the trace names as the byte tree
entry of csrc/fs_dither_cube.cu (``fs_dither<RgbPixels, TreeQuant,
...>``, launched by ops/sixel_kernel.py ``fs_dither_tree_rgb_cuda``).

A pixel: its RGBA read (4 bytes) and its index written (1), over the
HBM's 3.35 TB/s; and 71 float32 operations over 33.45 T/s, as counted
from the kernel's source: the row-above mix (15), the incoming sum and
clip (15), the error (3), and the tree quantizer: 3 roundings, 8 levels
of 4, the leaf's unpack 3 (38).  The operations bound it."""

from harness import roofline

TREE_OPS_PER_PX = 71
BYTES_PER_PX = 4 + 1


def is_tree_dither(name: str) -> bool:
    return "fs_dither" in name and "RgbPixels" in name \
        and "TreeQuant" in name


def read(r):
    if r.trace is None or r.frames == 0:
        return None
    device_s = r.trace.seconds(is_tree_dither)
    if device_s <= 0:
        return None
    cfg = r.run.config
    px = r.frames * int(cfg["out_h"]) * int(cfg["out_w"])
    bound = roofline.bound_s(px * BYTES_PER_PX, px * TREE_OPS_PER_PX)[0]
    return roofline.share_pct(bound, device_s)
