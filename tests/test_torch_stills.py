"""The port's still-image ops and RGBA windows against the JAX package.

Seeded inputs go through each new op of the port's still path and its
JAX counterpart, with byte equality: ``trim_rect`` (auto-crop bounds)
against ``_trim_bounds_impl`` (jitted on the CPU) and ``_trim_bounds_np``,
``resize_nearest`` (``-a``) and ``scroll_frames`` against the JAX ops,
and the RGBA window primers ``prime_block_planes`` and
``prime_sixel_planes`` against the JAX package's device branch
(TIMG_TPU_FORCE_DEVICE=1: its Pallas kernels in interpret mode, plane
transport).  The compose's root is held exact on its whole value lattice
and against a CPU root made low.  The whole CLI on stills is in
tests/test_torch_stills_cli.py.  Tests marked ``cuda`` hold the torch
ops of the still path on the card against their CPU results.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

from timg_tpu.options import DisplayOptions  # noqa: E402
from timg_tpu.render import plane_cache as jcache  # noqa: E402
from timg_tpu_torch.ops import autocrop as tautocrop  # noqa: E402
from timg_tpu_torch.ops import compose as tcompose  # noqa: E402
from timg_tpu_torch.ops import exact as texact  # noqa: E402
from timg_tpu_torch.ops import resize as tresize  # noqa: E402
from timg_tpu_torch.render import plane_cache as tcache  # noqa: E402
from timg_tpu_torch.sources import scroll as tscroll  # noqa: E402

F32 = np.float32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _rgba(seed, h, w, opaque=False):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    if opaque:
        img[..., 3] = 255
    return img


# ---------------------------------------------------------------- autocrop

def _trim_cases():
    rng = np.random.default_rng(5)
    cases = {}
    cases["uniform"] = np.full((9, 13, 4), 77, np.uint8)
    cases["uniform 1x1"] = np.full((1, 1, 4), 3, np.uint8)
    island = np.zeros((17, 23, 4), np.uint8)
    island[8, 11, 2] = 1
    cases["one-pixel island"] = island
    alpha_only = np.full((12, 10, 4), 200, np.uint8)
    alpha_only[3:5, 6, 3] = 199
    cases["alpha differs"] = alpha_only
    for edge in ("top", "bottom", "left", "right"):
        f = np.full((15, 19, 4), 40, np.uint8)
        f[5:9, 6:12] = rng.integers(0, 256, (4, 6, 4), dtype=np.uint8)
        if edge == "top":
            f[0, 3:7] = (1, 2, 3, 4)
        elif edge == "bottom":
            f[-1, 3:7] = (1, 2, 3, 4)
        elif edge == "left":
            f[10:13, 0] = (1, 2, 3, 4)
        else:
            f[10:13, -1] = (1, 2, 3, 4)
        cases[f"touches {edge}"] = f
    cases["noise"] = rng.integers(0, 256, (11, 7, 4), dtype=np.uint8)
    bordered = np.full((60, 90, 4), 200, np.uint8)
    bordered[20:40, 30:60] = rng.integers(0, 256, (20, 30, 4),
                                          dtype=np.uint8)
    cases["bordered"] = bordered
    return cases


@pytest.mark.parametrize("name", list(_trim_cases()))
def test_trim_rect_matches_jax(name):
    import jax

    from timg_tpu.ops.autocrop import _trim_bounds_impl, _trim_bounds_np

    frame = _trim_cases()[name]
    got = tautocrop.trim_rect(frame)
    want_np = _trim_bounds_np(frame)
    want_jit = tuple(int(v) for v in
                     np.asarray(jax.jit(_trim_bounds_impl)(frame)))
    assert got == want_np == want_jit


def test_auto_crop_matches_jax():
    from timg_tpu.ops import autocrop as jautocrop

    for frame in _trim_cases().values():
        for border in (0, 1, 3):
            np.testing.assert_array_equal(
                tautocrop.auto_crop(frame, border),
                jautocrop.auto_crop(frame, border))


# ----------------------------------------------------------- nearest, scroll

@pytest.mark.parametrize("shape,out", [
    ((2, 37, 53, 4), (12, 20)),        # down, odd factors
    ((1, 6, 8, 4), (19, 27)),          # up
    ((1, 40, 30, 4), (40, 61)),        # one axis kept, the other up
    ((3, 64, 64, 4), (1, 1))])
def test_resize_nearest_matches_jax(shape, out):
    from timg_tpu.ops.resize import resize_nearest

    frames = np.random.default_rng(sum(shape)).integers(
        0, 256, shape, dtype=np.uint8)
    got = tresize.resize_nearest(torch.from_numpy(frames), *out).numpy()
    want = np.asarray(resize_nearest(frames, *out))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dx,dy", [(3, 0), (-3, 0), (0, 2), (0, -2),
                                   (2, 3), (-2, -3), (5, -1), (-1, 4)])
def test_scroll_frames_match_jax(dx, dy):
    from timg_tpu.sources.scroll import scroll_frames

    img = _rgba(11, 21, 33)
    for start, count in ((0, 5), (7, 9)):
        got = tscroll.scroll_frames(img, 17, 13, dx, dy, start, count)
        want = scroll_frames(img, 17, 13, dx, dy, start, count)
        assert got.shape == want.shape == (count, 13, 17, 4)
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ RGBA windows

def _window(seed, b, h, w, alpha=False):
    """A seeded window of frames as the still path hands them over:
    gradients and noise, with a transparent corner when ``alpha``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((b, h, w, 4), np.uint8)
    for i in range(b):
        for c in range(3):
            out[i, ..., c] = (xx * (40 + 30 * c) // w + yy * 70 // h
                              + 17 * i + rng.integers(0, 24, (h, w))) % 256
        out[i, ..., 3] = 255
        if alpha:
            out[i, : h // 3, : w // 2, 3] = rng.integers(
                0, 255, (h // 3, w // 2))
    return out


def _opts(mode=None, cell_x=8, cell_y=16, bg=(0, 0, 0, 255), jax=False):
    if jax:
        opts = DisplayOptions()
    else:
        from timg_tpu_torch.options import DisplayOptions as TOptions
        opts = TOptions()
    opts.sixel_batch_dither = mode
    opts.cell_x_px, opts.cell_y_px = cell_x, cell_y
    opts.bgcolor_getter = (lambda: bg) if bg is not None else None
    return opts


@pytest.fixture
def jax_device_window(monkeypatch):
    """The JAX package's device branch on the CPU, plane transport."""
    monkeypatch.setenv("TIMG_TPU_FORCE_DEVICE", "1")
    monkeypatch.setenv("TIMG_TPU_SIXEL_TRANSPORT", "plane")


@pytest.mark.parametrize("mode,b,h,w,alpha", [
    ("cube", 2, 13, 21, False),
    ("cube", 1, 12, 9, True),
    ("adaptive", 2, 13, 21, True),
    ("libsixel", 3, 11, 17, False),
    ("libsixel", 2, 7, 1, True)])
def test_prime_sixel_planes_match_jax(jax_device_window, mode, b, h, w,
                                      alpha):
    """Each dither on a window whose height pads to a multiple of 6 with
    background rows (bg black, or none: zero rows), and a 1-px-wide
    one."""
    frames = _window(b * h + w, b, h, w, alpha)
    for bg in ((0, 0, 0, 255), None):
        got = list(frames.copy())
        want = list(frames.copy())
        state_t, state_j = {}, {}
        tcache.prime_sixel_planes(got, _opts(mode, bg=bg), state_t)
        jcache.prime_sixel_planes(want, _opts(mode, bg=bg, jax=True),
                                  state_j)
        for g, j in zip(got, want):
            gp, gpal, gq = tcache.SIXEL_PLANES.pop(g)
            jp, jpal, jq = jcache.SIXEL_PLANES.pop(j)
            np.testing.assert_array_equal(gp, np.asarray(jp))
            assert (gpal is None) == (jpal is None)
            if gpal is not None:
                np.testing.assert_array_equal(gpal, jpal)
        if mode == "adaptive":
            for a, c in zip(state_t["quantizer"], state_j["quantizer"]):
                np.testing.assert_array_equal(a, c)


def test_prime_sixel_planes_leaves_a_oneshot_libsixel_still():
    frames = list(_window(3, 1, 12, 10))
    tcache.prime_sixel_planes(frames, _opts("libsixel"), {})
    assert tcache.SIXEL_PLANES.pop(frames[0]) is None
    tcache.prime_sixel_planes(frames, _opts("libsixel"), {}, sustained=True)
    assert tcache.SIXEL_PLANES.pop(frames[0]) is not None


@pytest.mark.parametrize("cell_x,b,h,w,upper", [
    (2, 3, 10, 14, False),
    (2, 2, 9, 12, False),
    (2, 2, 9, 12, True),
    (1, 3, 7, 11, False),
    (1, 2, 8, 5, True),
    (2, 1, 6, 9, False)])       # odd width: left to the canvas
def test_prime_block_planes_match_jax(jax_device_window, monkeypatch, cell_x,
                                      b, h, w, upper):
    """Quarter and half cells of a window with transparent pixels (the
    cells' transparency overrides), odd heights (the blank row on top, or
    at the bottom with TIMG_USE_UPPER_BLOCK), and the diff of each frame
    against the one before."""
    if upper:
        monkeypatch.setenv("TIMG_USE_UPPER_BLOCK", "1")
    frames = _window(b + h * w, b, h, w, alpha=True)
    frames[-1, : h // 2] = frames[0, : h // 2]        # cells that repeat
    got, want = list(frames.copy()), list(frames.copy())
    tcache.prime_block_planes(got, _opts(cell_x=cell_x, cell_y=2))
    jcache.prime_block_planes(want, _opts(cell_x=cell_x, cell_y=2, jax=True))
    if cell_x == 2 and w % 2:
        assert tcache.BLOCK_PLANES.pop(got[0]) is None
        return
    prev_t = None
    for i, (g, j) in enumerate(zip(got, want)):
        tp = tcache.BLOCK_PLANES.pop(g)
        jp = jcache.BLOCK_PLANES.pop(j)
        np.testing.assert_array_equal(np.asarray(tp[0]), jp[0])
        for k in (1, 2, 3):              # glyph, fg, bg
            np.testing.assert_array_equal(tp[k], np.asarray(jp[k]))
        assert (tp[4] is None) == (jp[4] is None) == (i == 0)
        assert tp[4] is prev_t           # the canvas's identity check
        if i:
            np.testing.assert_array_equal(tp[5], np.asarray(jp[5]))
        prev_t = tp[0]


@pytest.mark.parametrize("dither", ["cube", "adaptive", "libsixel"])
def test_canvas_single_frame_route_matches_jax(dither):
    """Frames no window primed (an evicted plane, a frame of its own
    size): the canvas's single-frame route writes the JAX canvas's bytes
    for a still, an animation's first frame and a later one (libsixel: C
    quantizer for the still, the table dither at B=1 for animation
    frames; adaptive: the tree reused within an animation)."""
    from timg_tpu.options import SixelOptions
    from timg_tpu.render.sequencer import SeqType as JSeq
    from timg_tpu.render.sixel_render import SixelCanvas as JaxCanvas
    from timg_tpu_torch.render.sequencer import SeqType
    from timg_tpu_torch.render.sixel_render import SixelCanvas

    class Sink:
        def __init__(self):
            self.data = []

        def write_buffer(self, buf, seq_type, end_ms):
            self.data.append(buf)

    frames = _window(31, 3, 13, 21, alpha=True)
    got, want = Sink(), Sink()
    canvas = SixelCanvas(got, SixelOptions(), _opts(dither), dither=dither)
    jcanvas = JaxCanvas(want, SixelOptions(), _opts(dither, jax=True),
                        dither=dither)
    for frame, seq, jseq in zip(
            [frames[0], frames[1], frames[2], frames[0]],
            [SeqType.FRAME_IMMEDIATE, SeqType.START_OF_ANIMATION,
             SeqType.ANIMATION_FRAME, SeqType.ANIMATION_FRAME],
            [JSeq.FRAME_IMMEDIATE, JSeq.START_OF_ANIMATION,
             JSeq.ANIMATION_FRAME, JSeq.ANIMATION_FRAME]):
        canvas.send(0, 0, frame.copy(), seq)
        jcanvas.send(0, 0, frame.copy(), jseq)
        assert got.data[-1] == want.data[-1]
    assert b"".join(got.data).count(b"\033Pq") == 4


# ----------------------------------------------------------- compose repair

def _compose_inputs():
    """Every source value s and alpha a < 255 of each channel, over the
    black, white and checkerboard backgrounds (one frame each)."""
    s, a = np.meshgrid(np.arange(256), np.arange(255), indexing="ij")
    frame = np.stack([s, (s * 7 + 3) % 256, 255 - s, a], -1).astype(np.uint8)
    return frame[None]                                   # [1, 256, 255, 4]


_BACKGROUNDS = {"black": ((0, 0, 0, 255), (0, 0, 0, 0)),
                "white": ((255, 255, 255, 255), (0, 0, 0, 0)),
                "checker": ((255, 255, 255, 255), (0x99, 0x99, 0x99, 255))}


@pytest.mark.parametrize("bg", list(_BACKGROUNDS))
def test_compose_matches_jax_with_a_low_cpu_root(monkeypatch, bg):
    """The compose's CPU fault: a torch.sqrt about 150 ulps low on the
    card's host.  With the root made 2^-14 low, the port's compose must
    still write the JAX package's bytes; it takes no torch root."""
    import jax.numpy as jnp

    from timg_tpu.ops.compose import alpha_compose_background

    frame = _compose_inputs()
    bg_c, pat_c = _BACKGROUNDS[bg]
    want = np.asarray(alpha_compose_background(
        jnp.asarray(frame), jnp.asarray(np.array(bg_c, np.uint8)),
        jnp.asarray(np.array(pat_c, np.uint8)), pattern_w=3, pattern_h=2))
    real_sqrt = torch.sqrt

    def low_sqrt(x, *args, **kwargs):
        return real_sqrt(x) * (1.0 - 2.0 ** -14)

    monkeypatch.setattr(torch, "sqrt", low_sqrt)
    monkeypatch.setattr(torch.Tensor, "sqrt", low_sqrt)
    got = tcompose.alpha_compose_background(
        torch.from_numpy(frame), bg_c, pat_c, pattern_w=3,
        pattern_h=2).numpy()
    np.testing.assert_array_equal(got, want)


def test_exact_root_on_the_compose_lattice():
    """floor_sqrt_255 equals the truncated correctly rounded root
    (numpy's float32 sqrt) on every value the compose repacks: each
    source value s, alpha a < 255 and background channel value b, in the
    compose's float32 arithmetic."""
    s = np.arange(256, dtype=F32)
    a = np.arange(255, dtype=F32)
    b = np.arange(256, dtype=F32)
    lin = (s * s)[:, None, None] * a[None, :, None] \
        + (b * b)[None, None, :] * (F32(255) - a)[None, :, None]
    v = (lin.astype(F32) / F32(255)).astype(F32).ravel()
    want = np.minimum(np.sqrt(v), F32(255)).astype(np.uint8)
    got = texact.floor_sqrt_255(torch.from_numpy(v)).to(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)


def test_floor_sqrt_on_squares_and_their_neighbours():
    n = np.arange(256, dtype=F32)
    sq = n * n
    v = np.concatenate([sq, np.nextafter(sq, F32(-1)),
                        np.nextafter(sq, F32(70000))]).astype(F32)
    v = v[(v >= 0) & (v < 65536)]
    want = np.minimum(np.floor(np.sqrt(v.astype(np.float64))), 255)
    got = texact.floor_sqrt_255(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want.astype(F32))


# --------------------------------------------------------------- on the card

def _photo(h, w, seed=7):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.empty((1, h, w, 4), np.uint8)
    img[0, ..., 0] = (xx * 255 // w) ^ rng.integers(0, 16, (h, w))
    img[0, ..., 1] = (yy * 255 // h)
    img[0, ..., 2] = (xx + yy) * 255 // (w + h)
    img[0, ..., 3] = np.where((xx // 64 + yy // 64) % 3 == 0, 128, 255)
    return img


_CARD_SHAPES = [((48, 64), (40, 53)), ((27, 33), (27, 33)),
                ((512, 512), (320, 320)), ((6, 8), (240, 320)),
                ((3024, 4032), (768, 1024))]


@pytest.mark.cuda
@pytest.mark.parametrize("src,out", _CARD_SHAPES)
def test_still_ops_on_the_card_equal_the_cpu(cuda_device, src, out):
    """resize_batch (downsampling and, from tiny_8x6's size, upsampling),
    the compose (solid and checkerboard), resize_nearest and trim_rect's
    bounds on the card equal their CPU results, at the corpus sizes and a
    phone camera's 4032x3024."""
    frames = torch.from_numpy(_photo(*src))
    d = frames.to(cuda_device)
    oh, ow = out
    r_cpu = tresize.resize_batch(frames, oh, ow)
    r_gpu = tresize.resize_batch(d, oh, ow)
    assert torch.equal(r_gpu.cpu(), r_cpu)
    for bg, pat in _BACKGROUNDS.values():
        assert torch.equal(
            tcompose.alpha_compose_background(r_gpu, bg, pat, 16, 8).cpu(),
            tcompose.alpha_compose_background(r_cpu, bg, pat, 16, 8))
    assert torch.equal(tresize.resize_nearest(d, oh, ow).cpu(),
                       tresize.resize_nearest(frames, oh, ow))
    framed = torch.zeros((src[0] + 6, src[1] + 10, 4), dtype=torch.uint8)
    framed[3:-3, 4:-6] = frames[0]
    assert torch.equal(tautocrop._trim_bounds(framed.to(cuda_device)).cpu(),
                       tautocrop._trim_bounds(framed))


@pytest.mark.cuda
@pytest.mark.parametrize("size,display", [((21, 33), (17, 13)),
                                          ((768, 2730), (1280, 768))])
def test_scroll_frames_on_the_card_equal_the_cpu(cuda_device, monkeypatch,
                                                 size, display):
    img = _photo(*size)[0]
    for dx, dy in ((3, 0), (-3, 0), (0, 2), (-2, -3)):
        monkeypatch.setenv("TIMG_TPU_TORCH_DEVICE", "cuda")
        got = tscroll.scroll_frames(img, *display, dx, dy, 5, 16)
        assert got.is_cuda
        monkeypatch.setenv("TIMG_TPU_TORCH_DEVICE", "cpu")
        want = tscroll.scroll_frames(img, *display, dx, dy, 5, 16)
        assert torch.equal(got.cpu(), want)
