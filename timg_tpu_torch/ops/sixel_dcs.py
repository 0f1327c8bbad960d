"""Device-side sixel DCS byte emission (counterpart of
timg_tpu/ops/sixel_dcs.py): the transport without a host assembly leg.

The device writes each sixel band's DCS body bytes, so the host only
writes the header and palette and splices the band slices with '-'
separators (``splice_host``); for a given index plane the spliced
stream equals the C assembler's ``timg_sixel_encode`` byte for byte.

Algorithm (per frame and band, the JAX package's):
1. colour presence over the 256 palette slots; the first ``COLOR_CAP``
   present colours in ascending order (a band with more is reported by
   its count, and the caller falls back to the plane);
2. per listed colour, the band's mask row (sixel bits 0..5);
3. RLE: a run starts at x = 0 or where the mask changes; the row's
   trailing zero run is dropped, so an absent row vanishes;
4. every emitted byte belongs to one run-start cell: the x = 0 cell of a
   content row carries the row header ('$' before every content row but
   the band's first, then '#<colour>'), a run longer than 3 is
   '!<len><char>', a shorter one its char repeated;
5. cell byte counts -> band offsets -> the bytes, into padded [nb, cap]
   band buffers (``bucket_cap`` rounds cap up to a power of two).

A CUDA tensor goes to the hand kernels (ops/sixel_dcs_kernel.py,
csrc/sixel_dcs.cu: ``dcs_band_lens`` and ``dcs_emit``), a CPU tensor to
the plain PyTorch versions below, which follow the JAX device functions
op for op, one frame at a time (their vmap).  The numpy mirrors are the
JAX package's, copied.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from timg_tpu_torch.ops import sixel_dcs_kernel

_BIG = np.int32(2 ** 30)


class SixelDcs(NamedTuple):
    """Host-side device-emitted DCS body of one frame: padded per-band
    byte buffers + lengths.  ``splice_host`` turns it into the full
    stream.  Invariant: the index plane held only values < the palette
    length (true for every device dither: indices address palette
    slots), since the device emitter was sized with n_colors=256."""
    bands: np.ndarray      # [nb, cap] u8 (zero-padded tails)
    band_lens: np.ndarray  # [nb] i32
    h: int
    w: int

# Template layout per cell (byte positions within the cell's emission):
#   [optional '$'][optional '#' + color digits][run bytes]
# run bytes: len > 3 -> '!' + len digits + char;  len <= 3 -> char * len.
# Max cell bytes: 1 + 4 + 6 = 11 (color <= 255 -> 3 digits, len <= 9999).


def _digits(v: np.ndarray) -> np.ndarray:
    """Decimal digit count of non-negative ints (0 -> 1)."""
    v = np.asarray(v)
    return np.where(v >= 1000, 4,
                    np.where(v >= 100, 3, np.where(v >= 10, 2, 1)))


def plan_np(plane: np.ndarray, h: int, w: int, n_colors: int,
            color_cap: int):
    """Numpy mirror of the device planning pass.

    plane: [>=h, >=w] u8.  Returns (clist [nb, C] i32 with -1 padding,
    overflow bool, M [nb, C, w] u8) — the compacted per-band color
    lists and dense mask rows.
    """
    nb = (h + 5) // 6
    x = np.full((nb * 6, w), 256, np.int32)  # pad sentinel: matches no color
    x[:h] = plane[:h, :w]
    bands = x.reshape(nb, 6, w)

    # presence over palette colors only (out-of-palette indices drop)
    colors = np.arange(256, dtype=np.int32)
    present = np.zeros((nb, 256), bool)
    for r in range(6):
        present |= (bands[:, r, :, None] == colors[None, None, :]).any(1)
    present[:, n_colors:] = False

    counts = present.sum(1)
    overflow = bool((counts > color_cap).any())

    # compact: ascending color order, -1 padded (tiny per-band sort)
    key = np.where(present, colors[None, :], _BIG)
    key.sort(axis=1)
    clist = np.where(key[:, :color_cap] >= _BIG, -1,
                     key[:, :color_cap]).astype(np.int32)

    # dense mask rows against the compacted list
    C = color_cap
    M = np.zeros((nb, C, w), np.uint8)
    for r in range(6):
        eq = bands[:, None, r, :] == clist[:, :, None]
        M |= (eq.astype(np.uint8) << r)
    return clist, overflow, M


def layout_np(clist: np.ndarray, M: np.ndarray, w: int):
    """Numpy mirror of the RLE + byte-layout pass.

    Returns (cell fields dict, band_lens [nb] i32).  Cells are the
    dense [nb, C, w] grid; only run-start cells have nonzero length.
    """
    nb, C, _ = M.shape
    Mi = M.astype(np.int32)
    start = np.ones((nb, C, w), bool)
    start[:, :, 1:] = Mi[:, :, 1:] != Mi[:, :, :-1]

    xs = np.arange(w, dtype=np.int32)
    nxt = np.where(start, xs[None, None, :], _BIG)
    # next run start strictly after x (reverse exclusive min-scan)
    nxt = np.concatenate([nxt[:, :, 1:],
                          np.full((nb, C, 1), w, np.int32)], axis=2)
    nxt = np.minimum.accumulate(nxt[:, :, ::-1], axis=2)[:, :, ::-1]
    nxt = np.minimum(nxt, w)
    run_len = np.where(start, nxt - xs[None, None, :], 0)

    # trailing zero run dropped (absent rows vanish: their x=0 cell is it)
    trailing_zero = start & (Mi == 0) & (nxt >= w)
    emit_run = start & ~trailing_zero

    run_bytes = np.where(emit_run,
                         np.where(run_len > 3, 2 + _digits(run_len),
                                  run_len), 0)

    # headers fold into x=0 of content rows
    content = (M != 0).any(axis=2)                       # [nb, C]
    # '$' before every content row except the band's first
    first_content = np.zeros_like(content)
    for b in range(nb):
        idx = np.where(content[b])[0]
        if len(idx):
            first_content[b, idx[0]] = True
    dollar = content & ~first_content
    hdr_bytes = np.where(content,
                         1 + _digits(np.maximum(clist, 0))
                         + dollar.astype(np.int32), 0)    # '#'+digits(+'$')

    cell_bytes = run_bytes.copy()
    cell_bytes[:, :, 0] += hdr_bytes
    flat = cell_bytes.reshape(nb, -1)
    offs = np.zeros_like(flat)
    np.cumsum(flat[:, :-1], axis=1, out=offs[:, 1:])
    band_lens = offs[:, -1] + flat[:, -1]
    return dict(start=start, run_len=run_len, emit_run=emit_run,
                value=np.where(start, Mi, 0), cell_bytes=cell_bytes,
                offsets=offs.reshape(nb, C, w), hdr_bytes=hdr_bytes,
                dollar=dollar, content=content), band_lens.astype(np.int32)


def _cell_byte_np(k, color, value, run_len, hdr_len, has_dollar):
    """Byte at position k of one cell's emission (scalar mirror)."""
    if k < hdr_len:
        if has_dollar:
            if k == 0:
                return ord('$')
            k -= 1
        if k == 0:
            return ord('#')
        d = k - 1
        nd = len(str(color))
        return ord(str(color)[d]) if d < nd else 0
    k -= hdr_len
    ch = 0x3F + value
    if run_len > 3:
        if k == 0:
            return ord('!')
        s = str(run_len)
        if k - 1 < len(s):
            return ord(s[k - 1])
        return ch
    return ch


def emit_np(clist: np.ndarray, fields: dict, band_lens: np.ndarray,
            cap: int) -> np.ndarray:
    """Numpy mirror of the emission gather: [nb, cap] u8 padded bands."""
    nb, C, w = fields["start"].shape
    out = np.zeros((nb, cap), np.uint8)
    for b in range(nb):
        pos = 0
        for ci in range(C):
            color = int(clist[b, ci])
            if color < 0:
                continue
            hdr = int(fields["hdr_bytes"][b, ci])
            for x in range(w):
                n = int(fields["cell_bytes"][b, ci, x])
                if not n:
                    continue
                h0 = hdr if x == 0 else 0
                for k in range(n):
                    out[b, pos + k] = _cell_byte_np(
                        k, color, int(fields["value"][b, ci, x]),
                        int(fields["run_len"][b, ci, x]), h0,
                        bool(fields["dollar"][b, ci]))
                pos += n
        assert pos == int(band_lens[b]), (b, pos, int(band_lens[b]))
    return out


def encode_np(plane: np.ndarray, h: int, w: int, n_colors: int,
              color_cap: int = 64):
    """Full numpy mirror: plane -> (bands [nb, cap] u8, band_lens,
    overflow).  The mirror is slow (test oracle only)."""
    clist, overflow, M = plan_np(plane, h, w, n_colors, color_cap)
    if overflow:
        return None, None, True
    fields, band_lens = layout_np(clist, M, w)
    cap = int(band_lens.max()) if band_lens.size else 0
    return emit_np(clist, fields, band_lens, max(cap, 1)), band_lens, False


def splice_host(bands: np.ndarray, band_lens: np.ndarray, h: int, w: int,
                palette: np.ndarray) -> bytes:
    """Host splice: DCS prefix + palette + per-band slices joined with
    '-' + ST.  Byte-identical framing to timg_sixel_encode."""
    head = [b'\033Pq"1;1;%d;%d' % (w, h)]
    pal = palette.reshape(-1, 3)
    for i, (r, g, b) in enumerate(pal):
        head.append(b"#%d;2;%d;%d;%d" % (i, (int(r) * 100 + 127) // 255,
                                         (int(g) * 100 + 127) // 255,
                                         (int(b) * 100 + 127) // 255))
    mv = memoryview(np.ascontiguousarray(bands)).cast("B")
    cap = bands.shape[1] if bands.ndim == 2 else 0
    body = b"-".join(mv[i * cap:i * cap + int(band_lens[i])]
                     for i in range(bands.shape[0]))
    return b"".join(head) + body + b"\033\\"


# ---------------------------------------------------------------------------
# plain PyTorch versions of the JAX device functions (one frame each)
# ---------------------------------------------------------------------------

def _digits_t(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 1000, 4, torch.where(
        v >= 100, 3, torch.where(v >= 10, 2, 1)))


def plan_device(plane: torch.Tensor, h: int, w: int, n_colors: int,
                color_cap: int):
    """Planning pass of ONE frame's [>=h, >=w] u8 plane: (clist [nb, C]
    int32, -1 padded; counts [nb] int32; M [nb, C, w] uint8).  Presence
    is a scatter into 257 slots (the pad rows' 256 lands in the last,
    which no colour reads); the JAX package compares against all 256."""
    nb = (h + 5) // 6
    dev = plane.device
    x = plane[:h, :w].to(torch.int64)
    pad = nb * 6 - h
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad), value=256)
    bands = x.reshape(nb, 6, w)

    colors = torch.arange(256, dtype=torch.int32, device=dev)
    present = torch.zeros((nb, 257), dtype=torch.bool, device=dev)
    present.scatter_(1, bands.reshape(nb, 6 * w), True)
    present = present[:, :256] & (colors[None, :] < n_colors)
    counts = present.sum(1, dtype=torch.int32)

    key = torch.sort(torch.where(present, colors[None, :], int(_BIG)),
                     dim=1).values
    clist = torch.where(key[:, :color_cap] >= _BIG, -1,
                        key[:, :color_cap]).to(torch.int32)

    M = torch.zeros((nb, color_cap, w), dtype=torch.uint8, device=dev)
    for r in range(6):
        eq = bands[:, None, r, :] == clist[:, :, None]
        M = M | (eq.to(torch.uint8) << r)
    return clist, counts, M


def layout_device(clist: torch.Tensor, M: torch.Tensor, w: int):
    """RLE + byte layout of one frame: (fields tuple, band_lens [nb])."""
    nb, C, _ = M.shape
    dev = M.device
    Mi = M.to(torch.int32)
    xs = torch.arange(w, dtype=torch.int32, device=dev)
    start = torch.cat([torch.ones((nb, C, 1), dtype=torch.bool, device=dev),
                       Mi[:, :, 1:] != Mi[:, :, :-1]], dim=2)

    nxt = torch.where(start, xs[None, None, :], int(_BIG))
    nxt = torch.cat([nxt[:, :, 1:],
                     torch.full((nb, C, 1), w, dtype=torch.int32,
                                device=dev)], dim=2)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [2]), dim=2).values, [2])
    nxt = torch.clamp(nxt, max=w)
    run_len = torch.where(start, nxt - xs[None, None, :], 0)

    trailing_zero = start & (Mi == 0) & (nxt >= w)
    emit_run = start & ~trailing_zero

    run_bytes = torch.where(emit_run,
                            torch.where(run_len > 3, 2 + _digits_t(run_len),
                                        run_len), 0)

    content = (M != 0).any(dim=2)                          # [nb, C]
    seen_before = torch.cat(
        [torch.zeros((nb, 1), dtype=torch.bool, device=dev),
         torch.cumsum(content.to(torch.int32), dim=1)[:, :-1] > 0], dim=1)
    dollar = content & seen_before
    hdr_bytes = torch.where(content,
                            1 + _digits_t(torch.clamp(clist, min=0))
                            + dollar.to(torch.int32), 0)

    cell_bytes = run_bytes.clone()
    cell_bytes[:, :, 0] += hdr_bytes
    flat = cell_bytes.reshape(nb, -1)
    csum = torch.cumsum(flat, dim=1)
    offs = (csum - flat).reshape(nb, C, w)
    band_lens = csum[:, -1].to(torch.int32)
    value = torch.where(start, Mi, 0)
    return (value, run_len, cell_bytes, offs, hdr_bytes, dollar,
            torch.clamp(clist, min=0)), band_lens


def emit_device(fields, band_lens: torch.Tensor, w: int,
                cap: int) -> torch.Tensor:
    """Emission of one frame at band capacity ``cap``: [nb, cap] u8
    padded band buffers (zero tails)."""
    value, run_len, cell_bytes, offs, hdr_bytes, dollar, colors = fields
    nb, C, _ = value.shape
    dev = value.device
    ncell = C * w

    # map output bytes -> cells: one repeat with a per-band pad cell (id
    # = ncell + b) absorbing the slack up to cap
    flat_bytes = cell_bytes.reshape(nb, ncell)
    pad_lens = (cap - band_lens).to(torch.int32)
    lens_all = torch.cat([flat_bytes, pad_lens[:, None]], dim=1).reshape(-1)
    ids_all = torch.arange(nb * (ncell + 1), dtype=torch.int64, device=dev)
    cell_of_byte = torch.repeat_interleave(ids_all, lens_all.to(torch.int64),
                                           output_size=nb * cap)
    band_of_byte = cell_of_byte // (ncell + 1)
    cid = cell_of_byte % (ncell + 1)
    is_pad = cid >= ncell
    ci = torch.clamp(cid, max=ncell - 1) // w
    xx = torch.clamp(cid, max=ncell - 1) % w

    def g(a):
        return a[band_of_byte, ci, xx]

    def g2(a):
        return a[band_of_byte, ci]

    j = torch.arange(nb * cap, dtype=torch.int64, device=dev)
    k = j % cap - g(offs)                      # byte index within cell
    v = g(value)
    rl = g(run_len)
    hdr = torch.where(xx == 0, g2(hdr_bytes), 0)
    dol = g2(dollar) & (xx == 0)
    col = g2(colors)

    # header bytes: ['$']['#'][color digits]
    kh = k - dol.to(k.dtype)                   # position past '$'
    cd = torch.where(col >= 100, 3, torch.where(col >= 10, 2, 1))
    dpow = cd - kh                             # 0 => last digit (10^0)
    pow10 = torch.where(dpow <= 0, 1, torch.where(dpow == 1, 10, 100))
    hdr_byte = torch.where(
        (k == 0) & dol, ord('$'),
        torch.where(kh == 0, ord('#'), ord('0') + (col // pow10) % 10))

    # run bytes: ['!'][len digits][char] or repeated char
    kr = k - hdr
    ch = 0x3F + v
    ld = _digits_t(rl)
    rp = ld - kr                               # 0 => last digit (10^0)
    p10 = torch.where(rp <= 0, 1, torch.where(
        rp == 1, 10, torch.where(rp == 2, 100, 1000)))
    run_byte = torch.where(
        rl > 3,
        torch.where(kr == 0, ord('!'),
                    torch.where(kr <= ld, ord('0') + (rl // p10) % 10, ch)),
        ch)

    byte = torch.where(k < hdr, hdr_byte, run_byte)
    byte = torch.where(is_pad, 0, byte)
    return byte.to(torch.uint8).reshape(nb, cap)


def band_lens_device(plane: torch.Tensor, h: int, w: int, n_colors: int,
                     color_cap: int):
    """Sizing pass of one frame: (band_lens [nb], counts [nb])."""
    clist, counts, M = plan_device(plane, h, w, n_colors, color_cap)
    _, band_lens = layout_device(clist, M, w)
    return band_lens, counts


def encode_device(plane: torch.Tensor, h: int, w: int, n_colors: int,
                  color_cap: int, cap: int):
    """One frame at band capacity ``cap``: (bands [nb, cap] u8,
    band_lens [nb] int32, counts [nb] int32)."""
    clist, counts, M = plan_device(plane, h, w, n_colors, color_cap)
    fields, band_lens = layout_device(clist, M, w)
    return emit_device(fields, band_lens, w, cap), band_lens, counts


# ---------------------------------------------------------------------------
# batched transport entry points
# ---------------------------------------------------------------------------

COLOR_CAP = 64  # per-band distinct-color budget; beyond it -> plane


def batch_band_lens_plain(planes: torch.Tensor, n_frames: int, h: int,
                          w: int):
    """Plain version of ``batch_band_lens``."""
    out = [band_lens_device(planes[i], h, w, 256, COLOR_CAP)
           for i in range(n_frames)]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


def batch_encode_plain(planes: torch.Tensor, n_frames: int, h: int, w: int,
                       cap: int):
    """Plain version of ``batch_encode``."""
    out = [encode_device(planes[i], h, w, 256, COLOR_CAP, cap)
           for i in range(n_frames)]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


def batch_band_lens(planes: torch.Tensor, n_frames: int, h: int, w: int):
    """[B, >=h, >=w] u8 planes -> (band_lens [n, nb] int32, colour counts
    [n, nb] int32) on the planes' device (the kernel on CUDA)."""
    if planes.is_cuda:
        return sixel_dcs_kernel.dcs_band_lens_cuda(planes[:n_frames], h, w,
                                                   COLOR_CAP)
    return batch_band_lens_plain(planes, n_frames, h, w)


def batch_encode(planes: torch.Tensor, n_frames: int, h: int, w: int,
                 cap: int):
    """[B, >=h, >=w] u8 planes -> (bands [n, nb, cap] u8, band_lens
    [n, nb] int32); ``cap`` from ``bucket_cap`` of the lengths."""
    if planes.is_cuda:
        return sixel_dcs_kernel.dcs_emit_cuda(planes[:n_frames], h, w,
                                              COLOR_CAP, cap)
    return batch_encode_plain(planes, n_frames, h, w, cap)


def bucket_cap(max_band_bytes: int) -> int:
    """Round the band byte capacity up to a power of two (>=512), as the
    JAX package sizes its buffers."""
    c = 512
    while c < max_band_bytes:
        c *= 2
    return c
