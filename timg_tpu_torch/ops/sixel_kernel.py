"""Floyd-Steinberg dither with f32 carries: the CUDA kernel's wrappers and
the plain PyTorch versions (counterpart of timg_tpu/ops/sixel_pallas3.py's
cube and tree paths and of timg_tpu/ops/sixel_pallas.py).

On int32 RGBA words: ``fs_dither_cube_fused`` replaces the TPU kernels
``fs_dither_cube_fused`` (K6) with its layout kernels ``_skewT`` (K3),
``_transpose_bwd`` (K4) and ``_unskewT`` (K5); ``fs_dither_tree_fused``
replaces ``fs_dither_tree_fused`` (K7), the same wavefront with a
median-cut tree quantizer.  On [B, H, W, C >= 3] uint8 bytes:
``fs_dither_cube_rgb`` replaces ``fs_dither_cube_pallas`` (K9), and
``fs_dither_tree_rgb`` is the tree quantizer on the same input (an XLA
scan in the reference, ops/sixel.py:_fs_dither_tree_impl).  Each is one
CUDA launch of csrc/fs_dither_cube.cu, which walks the wavefront
x = t - 2y directly, one row a lane, bound by the latency of its
w + 2(h-1) serial steps; ``plan_bands`` spreads a frame's warps over
blocks ("bands") so that the batch fills the card's SMs.  The byte
entries read each pixel's first three channels in place.

The plain versions are the same wavefront in torch ops, mirroring
timg_tpu/ops/sixel_np.py:_wavefront_np step by step; the skew is a
strided view, so they run unchanged on the CPU and on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from timg_tpu_torch.ops.sixel_np import TREE_DEPTH
from timg_tpu_torch.ops import _build
from timg_tpu_torch.ops.sixel import _CUBE_LEVELS, INV_STEPS, STEPS

LAUNCHES = 0            # fs_dither_cube launches (words)
TREE_LAUNCHES = 0       # fs_dither_tree launches (words)
RGB_LAUNCHES = 0        # fs_dither_cube_rgb launches (K9, bytes)
TREE_RGB_LAUNCHES = 0   # fs_dither_tree_rgb launches (bytes)

_C7, _C5, _C3, _C1 = 7.0 / 16.0, 5.0 / 16.0, 3.0 / 16.0, 1.0 / 16.0

# The band plan of the CUDA driver (csrc/fs_dither_cube.cu): a warp owns
# 32 rows, a block at most MAX_WARPS warps; ``__launch_bounds__`` of
# MAX_WARPS * 32 threads lets ptxas use up to REGISTERS_PER_THREAD
# registers, so a full block fits the SM's REGISTERS_PER_SM.
ROWS_PER_WARP = 32
MAX_WARPS = 16
MIN_WARPS = 4
MAX_ROWS = 4096
CHUNK = 8                    # steps a chunk of the driver's step loop
CARRY_INTS = 8               # int32 words of one step's carry (Carry)
RING_STEPS = 64              # steps of a shared warp-edge ring (kRing)
REGISTERS_PER_SM = 65536
REGISTERS_PER_THREAD = 128
SMEM_PER_BLOCK = 232448      # the most a Hopper block can opt in to
# bytes of each quantizer's tables in a block's shared memory
# (kTableInts * 4): the tree's node pairs and leaves; libsixel's bucket
# table and palette words
QUANT_TABLE_BYTES = {"cube": 0, "tree": 4 * (2 * 8 * 128 + 256),
                     "table": (1 << 15) + 4 * 256}


def block_smem_bytes(quant: str, warps: int) -> int:
    """Dynamic shared memory of one block of the driver: the quantizer's
    tables, then per warp a ring of RING_STEPS carries and the step its
    reader has reached."""
    return QUANT_TABLE_BYTES[quant] + warps * (RING_STEPS * CARRY_INTS * 4
                                               + 4)


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """``bands`` blocks a frame, of ``warps`` warps each (32 rows a
    warp); the last band may hold fewer rows."""
    bands: int
    warps: int


def plan_bands(b: int, h: int, n_sms: int) -> BandPlan:
    """How many blocks a frame of h rows takes in a batch of b frames on
    a card of ``n_sms`` SMs: about n_sms / b bands a frame, so that the
    batch spreads over the SMs, with MIN_WARPS to MAX_WARPS warps a block
    (fewer only where the frame has fewer) and no empty band.  Four warps
    a block beat one or two at B=1 and B=8 on the H100 (PERF.md §6, PR 6):
    a warp edge inside a block hands its carries over through shared
    memory, a band edge through L2."""
    n_warps = -(-h // ROWS_PER_WARP)
    want = max(1, n_sms // max(b, 1))
    warps = min(n_warps, MAX_WARPS, max(MIN_WARPS, -(-n_warps // want)))
    return BandPlan(-(-n_warps // warps), warps)


def ticket_band(ticket: int, b: int) -> tuple:
    """(frame, band) of a block's ticket, as the driver maps it: band j
    of every frame comes after band j-1 of every frame, so a block waits
    only on blocks that took their tickets before it."""
    return ticket % b, ticket // b


def edge_len(h: int, w: int) -> int:
    """Steps of a band edge's carry array: every step a warp can run,
    rounded up to whole pairs of chunks."""
    return w + 2 * h + 4 * CHUNK


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        band = [i, i, p, p, i, p]    # bands, warps, sync, edges, len, stream
        lib.timg_fs_dither_cube.argtypes = [p, i, i, i, i, i, p, i] + band
        lib.timg_fs_dither_tree.argtypes = [p, i, i, i, i, i, p, p, p,
                                            i] + band
        lib.timg_fs_dither_cube_rgb.argtypes = [p, i, i, i, i, i, i, p,
                                                i] + band
        lib.timg_fs_dither_tree_rgb.argtypes = [p, i, i, i, i, i, i, p, p,
                                                p, i] + band
        lib.timg_fs_dither_table.argtypes = [p, i, i, i, i, i, p, p, p, p,
                                             i] + band
        for fn in ("cube", "tree", "cube_rgb", "tree_rgb", "table",
                   "cube_max_rows", "max_warps", "chunk", "smem_bytes"):
            getattr(lib, f"timg_fs_dither_{fn}").restype = ctypes.c_int
        for fn in ("cube_max_rows", "max_warps", "chunk"):
            getattr(lib, f"timg_fs_dither_{fn}").argtypes = []
        lib.timg_fs_dither_smem_bytes.argtypes = [i, i]
        smem = [lib.timg_fs_dither_smem_bytes(q, MAX_WARPS)
                for q in range(len(QUANT_TABLE_BYTES))]
        if (lib.timg_fs_dither_max_warps(), lib.timg_fs_dither_chunk(),
                lib.timg_fs_dither_cube_max_rows(), smem) != (
                    MAX_WARPS, CHUNK, MAX_ROWS,
                    [block_smem_bytes(q, MAX_WARPS)
                     for q in QUANT_TABLE_BYTES]):
            raise RuntimeError("csrc/fs_dither_cube.cu and ops/sixel_kernel"
                               ".py disagree on the band plan's limits")
        _bound = lib
    return _bound


def _as_words(frames: torch.Tensor) -> torch.Tensor:
    """[B, H, W] int32 words, or [B, H, W, 4] uint8 RGBA viewed as words."""
    if frames.dim() == 4:
        if frames.dtype != torch.uint8 or frames.shape[-1] != 4:
            raise ValueError("4-D input must be [B, H, W, 4] uint8")
        return frames.contiguous().view(torch.int32).squeeze(-1)
    if frames.dim() != 3 or frames.dtype != torch.int32:
        raise ValueError("input must be [B, H, W] int32 RGBA words")
    return frames


def _skew(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., h, w] -> strided view [..., h, w + 2(h-1)] with
    ``S[..., y, t] = x[..., y, t - 2y]`` (0 outside 0 <= t - 2y < w).

    Rows are padded right by 2h and flattened; row y's step t then sits
    at flat offset y*(w + 2h - 2) + t, where out-of-row reads land in
    zero padding (of row y itself, or of row y-1 for t < 2y)."""
    lead = x.shape[:-2]
    pad = torch.zeros(lead + (h, w + 2 * h), dtype=x.dtype, device=x.device)
    pad[..., :w] = x
    n_steps = w + 2 * (h - 1)
    stride = pad.stride()
    return pad.as_strided(lead + (h, n_steps),
                          stride[:-2] + (w + 2 * h - 2, 1))


def word_planes(words: torch.Tensor, h: int, w: int,
                dtype: torch.dtype) -> torch.Tensor:
    """[B, >=h, >=w] int32 RGBA words -> [B, 3, h, w] channel planes."""
    words = words[:, :h, :w]
    return torch.stack([((words >> (8 * c)) & 0xFF).to(dtype)
                        for c in range(3)], dim=1)


def rgb_planes(frames: torch.Tensor, h: int, w: int,
               dtype: torch.dtype) -> torch.Tensor:
    """[B, >=h, >=w, C >= 3] uint8 -> [B, 3, h, w] channel planes."""
    if frames.dim() != 4 or frames.dtype != torch.uint8 \
            or frames.shape[-1] < 3:
        raise ValueError("input must be [B, H, W, C >= 3] uint8")
    return frames[:, :h, :w, :3].permute(0, 3, 1, 2).to(dtype)


def wavefront_plain(planes: torch.Tensor, step_fn, carries: int,
                    out_u8: bool) -> torch.Tensor:
    """The FS wavefront in torch ops: [B, 3, h, w] channel planes (of the
    carries' dtype) -> [B, h, w] indices.  At step t, row y handles
    x = t - 2y; the rows with a pixel form the range [lo, hi).
    ``step_fn(col, carry, lo, hi) -> (idx [B, h] int32, new carry)``,
    where ``col`` is [B, 3, h] (0 off the image) and ``carry`` holds
    ``carries`` [B, 3, h] tensors, newest first; the error it returns
    must be 0 outside [lo, hi)."""
    b, _, h, w = planes.shape
    dev = planes.device
    cols = _skew(planes, h, w)                              # [B, 3, h, T]
    out_buf = torch.zeros((b, h, w + 2 * h), dtype=torch.int32, device=dev)
    out_steps = out_buf.as_strided(
        (b, h, w + 2 * (h - 1)),
        (out_buf.stride(0), w + 2 * h - 2, 1))
    carry = tuple(torch.zeros((b, 3, h), dtype=planes.dtype, device=dev)
                  for _ in range(carries))
    for t in range(w + 2 * (h - 1)):
        lo, hi = max(0, (t - w + 2) // 2), min(h, t // 2 + 1)
        idx, carry = step_fn(cols[..., t], carry, lo, hi)
        out_steps[..., t] = idx
    out = out_buf[:, :, :w]
    return out.to(torch.uint8) if out_u8 else out.contiguous()


def _fs_f32_step(quantize):
    """Step of the f32 wavefront (sixel_np._wavefront_np) around
    ``quantize(v [B, 3, h]) -> (idx [B, h], chosen [B, 3, h])``."""

    def step(col, carry, lo, hi):
        e1, e2, e3 = carry
        mix = e1 * _C3 + e2 * _C5 + e3 * _C1
        incoming = e1 * _C7
        incoming[:, :, 1:] += mix[:, :, :-1]
        v = torch.clamp(col + incoming, 0.0, 255.0)
        idx, chosen = quantize(v)
        err = v - chosen
        err[:, :, :lo] = 0.0
        err[:, :, hi:] = 0.0
        return idx, (err, e1, e2)
    return step


def _cube_quantize(dev: torch.device):
    step = torch.tensor(STEPS, dtype=torch.float32, device=dev).view(1, 3, 1)
    inv = torch.tensor(INV_STEPS, dtype=torch.float32,
                       device=dev).view(1, 3, 1)
    _, lg, lb = _CUBE_LEVELS

    def quantize(v):
        q = torch.round(v * step)
        qi = q.to(torch.int32)
        return (qi[:, 0] * lg + qi[:, 1]) * lb + qi[:, 2], torch.round(q * inv)
    return quantize


def _tree_quantize(levels: torch.Tensor, leaves: torch.Tensor,
                   dev: torch.device):
    levels = levels.to(dev, torch.int64)
    leaves = leaves.to(dev, torch.int64)

    def quantize(v):
        vq = torch.round(v)
        node = torch.zeros(vq[:, 0].shape, dtype=torch.int64, device=dev)
        for d in range(TREE_DEPTH):
            word = levels[d][node]
            axis = word >> 8
            comp = torch.where(axis == 0, vq[:, 0],
                               torch.where(axis == 1, vq[:, 1], vq[:, 2]))
            node = node * 2 + (comp > (word & 0xFF).to(torch.float32))
        leaf = leaves[node]
        chosen = torch.stack([((leaf >> s) & 0xFF).to(torch.float32)
                              for s in (16, 8, 0)], dim=1)
        return ((leaf >> 24) & 0xFF).to(torch.int32), chosen
    return quantize


def fs_dither_cube_plain(frames: torch.Tensor, h: int, w: int,
                         out_u8: bool = True) -> torch.Tensor:
    """Plain PyTorch wavefront: [B, >=h, >=w] int32 words (or [B,H,W,4]
    uint8) -> [B, h, w] cube indices (uint8, or int32)."""
    words = _as_words(frames)
    return wavefront_plain(word_planes(words, h, w, torch.float32),
                           _fs_f32_step(_cube_quantize(words.device)), 3,
                           out_u8)


def fs_dither_tree_plain(frames: torch.Tensor, levels: torch.Tensor,
                         leaves: torch.Tensor, h: int, w: int,
                         out_u8: bool = True) -> torch.Tensor:
    """Plain PyTorch wavefront with the median-cut tree quantizer
    (sixel_np.fs_dither_tree_np): ``levels`` [8, 128] int32 packs
    ``axis << 8 | thr`` (descend right iff rint(v[axis]) > thr),
    ``leaves`` [256] int32 packs ``idx << 24 | r << 16 | g << 8 | b``."""
    words = _as_words(frames)
    return wavefront_plain(
        word_planes(words, h, w, torch.float32),
        _fs_f32_step(_tree_quantize(levels, leaves, words.device)), 3,
        out_u8)


def fs_dither_cube_rgb_plain(frames: torch.Tensor, h: int, w: int,
                             out_u8: bool = False) -> torch.Tensor:
    """Plain PyTorch wavefront on bytes: [B, >=h, >=w, C >= 3] uint8 ->
    [B, h, w] cube indices (int32, or uint8 with ``out_u8``)."""
    return wavefront_plain(rgb_planes(frames, h, w, torch.float32),
                           _fs_f32_step(_cube_quantize(frames.device)), 3,
                           out_u8)


def fs_dither_tree_rgb_plain(frames: torch.Tensor, levels: torch.Tensor,
                             leaves: torch.Tensor, h: int, w: int,
                             out_u8: bool = False) -> torch.Tensor:
    """Plain PyTorch wavefront on bytes with the tree quantizer:
    [B, >=h, >=w, C >= 3] uint8 -> [B, h, w] indices."""
    return wavefront_plain(
        rgb_planes(frames, h, w, torch.float32),
        _fs_f32_step(_tree_quantize(levels, leaves, frames.device)), 3,
        out_u8)


def _pitched_words(frames: torch.Tensor, h: int, w: int,
                   name: str) -> torch.Tensor:
    """CUDA words [B, ph >= h, pw >= w], row-major (made so if not)."""
    words = _as_words(frames)
    if not words.is_cuda:
        raise ValueError(f"{name} takes a CUDA tensor")
    if words.stride(2) != 1 or words.stride(1) != words.shape[2] \
            or words.stride(0) != words.shape[1] * words.shape[2]:
        words = words.contiguous()
    if words.shape[1] < h or words.shape[2] < w:
        raise ValueError(f"words {tuple(words.shape)} smaller than {h}x{w}")
    _check_rows(h, name)
    return words


def _check_rows(h: int, name: str) -> None:
    max_rows = _lib().timg_fs_dither_cube_max_rows()
    if h > max_rows:
        raise ValueError(f"{name}: h={h} exceeds {max_rows} rows")


def _launch(entry: str, data: list, b: int, h: int, w: int,
            dev: torch.device, out_u8: bool) -> torch.Tensor:
    """Allocate [b, h, w] indices and launch ``timg_fs_dither_<entry>``
    with its data arguments ``data`` (pointers as tensors), the output,
    and the band plan with its scratch, zeroed on the current stream: the
    ticket counter and the band edges' carries."""
    out = torch.empty((b, h, w), dtype=torch.uint8 if out_u8 else torch.int32,
                      device=dev)
    plan = plan_bands(b, h, _sm_count(dev.index or 0))
    n = edge_len(h, w)
    sync = torch.zeros(1, dtype=torch.int32, device=dev)
    carries = torch.zeros(max(1, b * (plan.bands - 1) * n * CARRY_INTS),
                          dtype=torch.int32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    args = [ptr(a) if isinstance(a, torch.Tensor) else a for a in data]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):         # the C launch's current device
        _build.check(getattr(_lib(), f"timg_fs_dither_{entry}")(
            *args, ptr(out), int(out_u8), plan.bands, plan.warps, ptr(sync),
            ptr(carries), n, ctypes.c_void_p(stream)), f"fs_dither_{entry}")
    return out


def _cuda_bytes(frames: torch.Tensor, h: int, w: int,
                name: str) -> torch.Tensor:
    """CUDA [B, H >= h, W >= w, C >= 3] uint8, row-major (made so if
    not; the channels are read in place, never packed into words)."""
    if not frames.is_cuda:
        raise ValueError(f"{name} takes a CUDA tensor")
    if frames.dim() != 4 or frames.dtype != torch.uint8 \
            or frames.shape[-1] < 3:
        raise ValueError(f"{name}: input must be [B, H, W, C >= 3] uint8")
    frames = frames.contiguous()
    if frames.shape[1] < h or frames.shape[2] < w:
        raise ValueError(f"frames {tuple(frames.shape)} smaller than "
                         f"{h}x{w}")
    _check_rows(h, name)
    return frames


def _tree_tables(levels: torch.Tensor, leaves: torch.Tensor,
                 dev: torch.device):
    levels = levels.to(dev, torch.int32).contiguous()
    leaves = leaves.to(dev, torch.int32).contiguous()
    if tuple(levels.shape) != (TREE_DEPTH, 128) \
            or tuple(leaves.shape) != (1 << TREE_DEPTH,):
        raise ValueError("tree tables must be levels [8, 128] and "
                         "leaves [256]")
    return levels, leaves


def fs_dither_cube_cuda(frames: torch.Tensor, h: int, w: int,
                        out_u8: bool = True) -> torch.Tensor:
    """The CUDA kernel: [B, >=h, >=w] int32 CUDA words -> [B, h, w]."""
    global LAUNCHES
    words = _pitched_words(frames, h, w, "fs_dither_cube_cuda")
    b, ph, pw = words.shape
    out = _launch("cube", [words, b, h, w, ph, pw], b, h, w, words.device,
                  out_u8)
    LAUNCHES += 1
    return out


def fs_dither_tree_cuda(frames: torch.Tensor, levels: torch.Tensor,
                        leaves: torch.Tensor, h: int, w: int,
                        out_u8: bool = True) -> torch.Tensor:
    """The CUDA kernel with the tree quantizer: [B, >=h, >=w] int32 CUDA
    words, one tree for the batch -> [B, h, w] indices."""
    global TREE_LAUNCHES
    words = _pitched_words(frames, h, w, "fs_dither_tree_cuda")
    b, ph, pw = words.shape
    levels, leaves = _tree_tables(levels, leaves, words.device)
    out = _launch("tree", [words, b, h, w, ph, pw, levels, leaves], b, h, w,
                  words.device, out_u8)
    TREE_LAUNCHES += 1
    return out


def fs_dither_cube_rgb_cuda(frames: torch.Tensor, h: int, w: int,
                            out_u8: bool = False) -> torch.Tensor:
    """The CUDA kernel on bytes (K9): [B, >=h, >=w, C >= 3] uint8 CUDA
    frames -> [B, h, w] cube indices."""
    global RGB_LAUNCHES
    frames = _cuda_bytes(frames, h, w, "fs_dither_cube_rgb_cuda")
    b, ph, pw, ch = frames.shape
    out = _launch("cube_rgb", [frames, b, h, w, ph, pw, ch], b, h, w,
                  frames.device, out_u8)
    RGB_LAUNCHES += 1
    return out


def fs_dither_tree_rgb_cuda(frames: torch.Tensor, levels: torch.Tensor,
                            leaves: torch.Tensor, h: int, w: int,
                            out_u8: bool = False) -> torch.Tensor:
    """The CUDA kernel on bytes with the tree quantizer:
    [B, >=h, >=w, C >= 3] uint8 CUDA frames, one tree for the batch ->
    [B, h, w] indices."""
    global TREE_RGB_LAUNCHES
    frames = _cuda_bytes(frames, h, w, "fs_dither_tree_rgb_cuda")
    b, ph, pw, ch = frames.shape
    levels, leaves = _tree_tables(levels, leaves, frames.device)
    out = _launch("tree_rgb", [frames, b, h, w, ph, pw, ch, levels, leaves],
                  b, h, w, frames.device, out_u8)
    TREE_RGB_LAUNCHES += 1
    return out


def fs_dither_cube_fused(frames: torch.Tensor, h: int, w: int,
                         out_u8: bool = True) -> torch.Tensor:
    """[B, H, W] int32 RGBA words (or [B, H, W, 4] uint8), possibly
    padded beyond h x w, -> [B, h, w] cube-palette FS indices (uint8
    with ``out_u8``, else int32); the contract of
    timg_tpu/ops/sixel_pallas3.py:fs_dither_cube_fused.  A CUDA tensor
    launches the kernel, a CPU tensor runs the plain version."""
    if frames.is_cuda:
        return fs_dither_cube_cuda(frames, h, w, out_u8)
    return fs_dither_cube_plain(frames, h, w, out_u8)


def fs_dither_tree_fused(frames: torch.Tensor, levels: torch.Tensor,
                         leaves: torch.Tensor, h: int, w: int,
                         out_u8: bool = True) -> torch.Tensor:
    """[B, H, W] int32 RGBA words (or [B, H, W, 4] uint8), possibly
    padded beyond h x w, -> [B, h, w] median-cut tree FS indices; the
    contract of timg_tpu/ops/sixel_pallas3.py:fs_dither_tree_fused with
    ``levels``/``leaves`` from sixel_np.median_cut_tree.  A CUDA tensor
    launches the kernel, a CPU tensor runs the plain version."""
    if frames.is_cuda:
        return fs_dither_tree_cuda(frames, levels, leaves, h, w, out_u8)
    return fs_dither_tree_plain(frames, levels, leaves, h, w, out_u8)


def fs_dither_cube_rgb(frames: torch.Tensor, h: int, w: int,
                       out_u8: bool = False) -> torch.Tensor:
    """[B, H, W, C >= 3] uint8, possibly larger than h x w, -> [B, h, w]
    cube-palette FS indices (int32, or uint8 with ``out_u8``); the
    contract of timg_tpu/ops/sixel_pallas.py:fs_dither_cube_pallas.  A
    CUDA tensor launches the kernel, a CPU tensor runs the plain
    version."""
    if frames.is_cuda:
        return fs_dither_cube_rgb_cuda(frames, h, w, out_u8)
    return fs_dither_cube_rgb_plain(frames, h, w, out_u8)


def fs_dither_tree_rgb(frames: torch.Tensor, levels: torch.Tensor,
                       leaves: torch.Tensor, h: int, w: int,
                       out_u8: bool = False) -> torch.Tensor:
    """[B, H, W, C >= 3] uint8, possibly larger than h x w, -> [B, h, w]
    median-cut tree FS indices; the contract of
    timg_tpu/ops/sixel.py:_fs_dither_tree_impl.  A CUDA tensor launches
    the kernel, a CPU tensor runs the plain version."""
    if frames.is_cuda:
        return fs_dither_tree_rgb_cuda(frames, levels, leaves, h, w, out_u8)
    return fs_dither_tree_rgb_plain(frames, levels, leaves, h, w, out_u8)
