"""The port's decoders (Radiance HDR, text, XCF and the other
GraphicsMagick formats, SVG, PDF, PostScript, OpenSlide) and its source
factory against the JAX package's on the CPU.

Each decoder opens the same file in both packages: the frames (decoded
on the host, then resized and composed by each package's still path:
the JAX package's numpy mirrors, the port's plain versions) must be
byte-equal, and so must the CLI streams in ``-pq`` and ``-ps``.  The
files come from the JAX package's own tests' writers (tests/test_hdr.py,
tests/test_gm_formats.py, tests/test_xcf.py).  PDF and OpenSlide run
against the mock libraries of tests/test_pdf.py and
tests/test_openslide.py (the real ones are absent here), PostScript
against a stand-in ``gs`` as tests/test_ps.py does; SVG needs librsvg
and cairo and skips without them.  The factory must try the decoders in
the JAX package's order and give its diagnostics.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

import timg_tpu.sources as jsources  # noqa: E402
import timg_tpu_torch.sources as tsources  # noqa: E402
from timg_tpu.options import DisplayOptions as JOptions  # noqa: E402
from timg_tpu_torch.options import DisplayOptions as TOptions  # noqa: E402

from tests.test_gm_formats import (write_cineon, write_dpx,  # noqa: E402
                                   write_miff, write_rla, write_xwd)
from tests.test_hdr import (_encode_flat, _encode_rle,  # noqa: E402
                            _random_rgbe)
from tests.test_xcf import write_xcf  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
SVG = """<svg xmlns="http://www.w3.org/2000/svg" width="100" height="80">
  <rect width="100" height="80" fill="#336699"/>
  <circle cx="50" cy="40" r="30" fill="#ffcc00" fill-opacity="0.6"/>
</svg>"""
PS_BODY = (b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 200 100\n%%Pages: 2\n"
           b"showpage\nshowpage\n")


def _xcf_bytes():
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    top = rng.integers(0, 256, (20, 24, 4), dtype=np.uint8)
    top[..., 3] = np.linspace(0, 255, 24).astype(np.uint8)
    return write_xcf([{"pix": top, "type": 1, "ox": 10, "oy": 6,
                       "opacity": 200},
                      {"pix": base, "type": 0}], 56, 40)


def _hdr_bytes(rle):
    rgbe = _random_rgbe(48, 30, seed=3)
    rgbe[:, 16:32] = rgbe[:, 16:17]
    return _encode_rle(rgbe) if rle else _encode_flat(rgbe)


def _write(d, name, data):
    p = d / name
    p.write_bytes(data)
    return str(p)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("decoders")
    rng = np.random.default_rng(12)
    rgb10 = rng.integers(0, 1024, (40, 60, 3), dtype=np.uint16)
    rgb8 = rng.integers(0, 256, (30, 40, 3), dtype=np.uint32)
    rgba = rng.integers(0, 256, (9, 33, 4), dtype=np.uint8)
    rgba[:, 5:15] = 77
    out = {
        "hdr": _write(d, "flat.hdr", _hdr_bytes(False)),
        "hdr-rle": _write(d, "rle.hdr", _hdr_bytes(True)),
        "dpx": _write(d, "img.dpx", write_dpx(rgb10)),
        "cin": _write(d, "img.cin", write_cineon(rgb10)),
        "xwd": _write(d, "img.xwd", write_xwd(
            rng.integers(0, 256, (24, 31, 3), dtype=np.uint8))),
        "miff": _write(d, "img.miff", write_miff(rgb8)),
        "rla": _write(d, "img.rla", write_rla(rgba)),
        "xcf": _write(d, "img.xcf", _xcf_bytes()),
        "txt": _write(d, "notes.txt", b"hello timg\nsecond line\n"
                                      b"\ta tab and a long line " * 3),
        "svg": _write(d, "pic.svg", SVG.encode()),
        "pdf": _write(d, "doc.pdf", b"%PDF-1.4 mock"),
        "ps": _write(d, "doc.ps", PS_BODY),
        "openslide": _write(d, "scan.svs", b"MOCKSLIDE"),
    }
    return out


def _gcc_mock(tmp_path_factory, name, libs=()):
    src = os.path.join(TESTS, f"mock_{name}.c")
    so = str(tmp_path_factory.mktemp(name) / f"lib{name}_mock.so")
    subprocess.run(["gcc", "-shared", "-fPIC", src, "-o", so, *libs],
                   check=True)
    return so


@pytest.fixture(scope="module")
def mocks(tmp_path_factory):
    """The mock poppler-glib (real cairo) and libopenslide of the JAX
    package's tests, built once; None where cairo/gobject are absent."""
    import ctypes
    try:
        ctypes.CDLL("libcairo.so.2")
        ctypes.CDLL("libgobject-2.0.so.0")
        poppler = _gcc_mock(tmp_path_factory, "poppler",
                            ["-l:libcairo.so.2"])
    except OSError:
        poppler = None
    return {"pdf": poppler,
            "openslide": _gcc_mock(tmp_path_factory, "openslide")}


@pytest.fixture
def libraries(mocks, tmp_path, monkeypatch):
    """Both packages' PDF, OpenSlide and PostScript sources pointed at the
    mocks and a stand-in gs that renders two grey pages from the
    requested dpi and the 200x100 pt BoundingBox."""
    from timg_tpu.sources import openslide_source as jslide
    from timg_tpu.sources import pdf_source as jpdf
    from timg_tpu.sources import ps_source as jps
    from timg_tpu_torch.sources import openslide_source as tslide
    from timg_tpu_torch.sources import pdf_source as tpdf
    from timg_tpu_torch.sources import ps_source as tps

    if mocks["pdf"]:
        monkeypatch.setenv("TIMG_POPPLER_GLIB_LIB", mocks["pdf"])
    monkeypatch.setenv("TIMG_OPENSLIDE_LIB", mocks["openslide"])
    gs = tmp_path / "gs"
    gs.write_text(f"""#!{sys.executable}
import sys
import numpy as np
from PIL import Image
out = dpi = None
for a in sys.argv[1:]:
    if a.startswith("-sOutputFile="):
        out = a[len("-sOutputFile="):]
    if a.startswith("-r"):
        dpi = float(a[2:])
w, h = round(200 * dpi / 72.0), round(100 * dpi / 72.0)
yy, xx = np.mgrid[0:h, 0:w]
for page, lum in ((1, 40), (2, 200)):
    arr = np.stack([(xx * 255 // w + lum) % 256, yy * 255 // h,
                    np.full((h, w), lum)], -1).astype(np.uint8)
    Image.fromarray(arr).save(out % page)
""")
    gs.chmod(0o755)
    for pdf, slide, ps in ((jpdf, jslide, jps), (tpdf, tslide, tps)):
        monkeypatch.setattr(pdf, "_tried", False)
        monkeypatch.setattr(pdf, "_libs", None)
        slide._lib.cache_clear()
        monkeypatch.setattr(ps, "find_gs", lambda: str(gs))
    yield mocks
    for slide in (jslide, tslide):
        slide._lib.cache_clear()


# name -> (module, class) in either package's sources/
DECODERS = {"hdr": ("hdr_source", "HDRSource"),
            "hdr-rle": ("hdr_source", "HDRSource"),
            "dpx": ("gm_formats", "GMFormatsSource"),
            "cin": ("gm_formats", "GMFormatsSource"),
            "xwd": ("gm_formats", "GMFormatsSource"),
            "miff": ("gm_formats", "GMFormatsSource"),
            "rla": ("gm_formats", "GMFormatsSource"),
            "xcf": ("gm_formats", "GMFormatsSource"),
            "txt": ("text_source", "TextSource"),
            "svg": ("svg_source", "SVGSource"),
            "pdf": ("pdf_source", "PDFSource"),
            "ps": ("ps_source", "PSSource"),
            "openslide": ("openslide_source", "OpenSlideSource")}


def _need(name, libraries):
    if name == "svg":
        from timg_tpu_torch.sources.svg_source import _load
        if _load() is None:
            pytest.skip("librsvg/cairo unavailable")
    if name == "pdf" and not libraries["pdf"]:
        pytest.skip("cairo/gobject unavailable for the mock poppler")


def _opts(cls, w, h, cell_x=2, cell_y=2):
    opts = cls()
    opts.width, opts.height = w, h
    opts.cell_x_px, opts.cell_y_px = cell_x, cell_y
    opts.bgcolor_getter = lambda: (0, 0, 0, 255)
    return opts


@pytest.mark.parametrize("name", list(DECODERS))
def test_decoder_frames_match_jax(libraries, files, name):
    """Each decoder's frames, orig size and decoder name equal the JAX
    decoder's on the same file (target 80x60 pixels, and 200x150 for an
    upscale)."""
    _need(name, libraries)
    module, cls = DECODERS[name]
    jcls = getattr(importlib.import_module(f"timg_tpu.sources.{module}"),
                   cls)
    tcls = getattr(importlib.import_module(
        f"timg_tpu_torch.sources.{module}"), cls)
    for w, h in ((80, 60), (200, 150)):
        jsrc, tsrc = jcls(files[name]), tcls(files[name])
        assert jsrc.load_and_scale(_opts(JOptions, w, h), 0, -1)
        assert tsrc.load_and_scale(_opts(TOptions, w, h), 0, -1)
        assert (tsrc.orig_width, tsrc.orig_height, tsrc.decoder_name,
                tsrc.max_frames) == (jsrc.orig_width, jsrc.orig_height,
                                     jsrc.decoder_name, jsrc.max_frames)
        assert len(tsrc.frames) == len(jsrc.frames) > 0
        for t, j in zip(tsrc.frames, jsrc.frames):
            np.testing.assert_array_equal(np.asarray(t.frame),
                                          np.asarray(j.frame))


def _run_rc(main, argv, out_path):
    """``_run_pty`` that returns the exit code beside the stream."""
    from tests.test_protocols import _with_scripted_pty

    def inner(slave):
        saved = os.dup(1)
        try:
            os.dup2(slave, 1)
            rc = main(argv + ["-o", str(out_path)])
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        return rc, out_path.read_bytes() if out_path.exists() else b""

    return _with_scripted_pty(inner, {})


@pytest.mark.parametrize("flags", [["-pq"], ["-ps", "--dither=cube"]],
                         ids=["pq", "cube"])
@pytest.mark.parametrize("name", list(DECODERS))
def test_cli_stream_matches_jax(libraries, files, tmp_path, name, flags):
    """The CLI streams at -g40x20 (320x320 pixels in sixel, 80x40 in
    quarter blocks).  A PDF page smaller than the sixel canvas is not
    scaled, and the JAX package's PDF source then hands cairo its float
    page size, which it refuses: both CLIs exit 1 and write nothing
    (a fault of the JAX package that the port's copy keeps; ROADMAP
    section 3)."""
    from timg_tpu.cli import main as jax_main
    from timg_tpu_torch.cli import main as torch_main

    _need(name, libraries)
    argv = ["--debug-no-frame-delay", "-g40x20", "-b", "black", *flags,
            files[name]]
    want = _run_rc(jax_main, argv, tmp_path / "jax.out")
    got = _run_rc(torch_main, argv, tmp_path / "torch.out")
    assert got == want
    if name == "pdf" and "-ps" in flags:
        assert got == (1, b"")
    else:
        assert got[0] == 0 and len(got[1]) > 100


def _factory_case(d, case):
    """(path, name) for each factory case: a file each decoder takes,
    and the failures the diagnostics name."""
    if case == "missing":
        return str(d / "nope.dpx")
    if case == "directory":
        return str(d)
    if case == "broken-dpx":
        return _write(d, "broken.dpx", b"\x01\x02GARBAGE" + bytes(64))
    if case == "gm-only":
        return _write(d, "x.pict", b"\0" * 64)
    if case == "miff-zip":
        data = write_miff(np.zeros((2, 2, 3), np.uint32))
        return _write(d, "z.miff", data.replace(b"compression=None",
                                                b"compression=Zip"))
    if case == "binary-txt":
        return _write(d, "x.txt", b"ab\0cd")
    if case == "hdr-as-png":       # signature-gated, not suffix-gated
        return _write(d, "hdr.png", _hdr_bytes(False))
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["missing", "directory", "broken-dpx",
                                  "gm-only", "miff-zip", "binary-txt",
                                  "hdr-as-png"])
def test_factory_diagnostics_match_jax(libraries, tmp_path, case):
    from timg_tpu.sources.base import create_source as jcreate
    from timg_tpu_torch.sources.base import create_source as tcreate

    path = _factory_case(tmp_path, case)
    jsrc, jerr = jcreate(path, _opts(JOptions, 40, 40),
                         attempt_video_loading=False)
    tsrc, terr = tcreate(path, _opts(TOptions, 40, 40),
                         attempt_video_loading=False)
    assert terr == jerr
    assert (tsrc is None) == (jsrc is None)
    if tsrc is not None:
        assert type(tsrc).__name__ == type(jsrc).__name__


def test_factory_order_matches_jax(libraries, files, monkeypatch):
    """Every decoder's file goes to the same decoder class in both
    factories (PostScript before Pillow, the GM formats before Pillow,
    text last), and the order in which the candidates are tried is the
    JAX factory's."""
    from timg_tpu.sources.base import create_source as jcreate
    from timg_tpu_torch.sources.base import create_source as tcreate

    for name, path in files.items():
        if name in ("svg", "pdf"):
            try:
                _need(name, libraries)
            except pytest.skip.Exception:
                continue
        jsrc, jerr = jcreate(path, _opts(JOptions, 40, 40))
        tsrc, terr = tcreate(path, _opts(TOptions, 40, 40))
        assert jsrc is not None and tsrc is not None, (name, jerr, terr)
        assert type(tsrc).__name__ == type(jsrc).__name__ \
            == DECODERS[name][1]

    tried = {}
    for pkg, create in (("jax", jcreate), ("torch", tcreate)):
        order = tried.setdefault(pkg, [])
        root = jsources if pkg == "jax" else tsources
        for module, cls in {DECODERS[n] for n in DECODERS} | {
                ("pil_source", "PILSource"), ("qoi_source", "QOISource"),
                ("video_source", "VideoSource")}:
            mod = importlib.import_module(f"{root.__name__}.{module}")
            original = getattr(mod, cls)

            def probe(self, *args, _cls=cls, _order=order):
                _order.append(_cls)
                return False

            monkeypatch.setattr(original, "load_and_scale", probe)
        create(files["txt"], _opts(JOptions if pkg == "jax" else TOptions,
                                   40, 40))
    assert tried["torch"] == tried["jax"]
    assert tried["torch"][0] == "OpenSlideSource"
    assert tried["torch"][-1] == "TextSource"
