"""The port stands alone: timg_tpu_torch imports neither jax nor anything
of the JAX package (timg_tpu), and its native helper is its own copy.

Tolerance: byte equality for the C assembler copy against timg_tpu's.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "timg_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "timg_tpu")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "timg-tpu-torch")]
    for top in (PORT, os.path.join(REPO, "tools")):
        for root, _, files in os.walk(top):
            out += [os.path.join(root, f) for f in files
                    if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.lineno, node.module


def test_no_module_of_the_port_imports_jax_or_timg_tpu():
    """An AST walk of every .py under timg_tpu_torch/ and tools/, of
    chip_smoke.py and of the launcher, function-level imports
    included."""
    sources = _port_sources()
    assert len(sources) > 30
    bad = [f"{os.path.relpath(p, REPO)}:{line}: {mod}"
           for p in sources for line, mod in _imported_modules(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import timg_tpu_torch.cli, timg_tpu_torch.models\n"
        "import timg_tpu_torch.render.sixel_render\n"
        "import timg_tpu_torch.sources.video_source\n"
        "import timg_tpu_torch.serve, timg_tpu_torch.version\n"
        "import timg_tpu_torch.parallel.auto, timg_tpu_torch.parallel.mesh\n"
        "import timg_tpu_torch.fast\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(','.join(bad))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, TIMG_TPU_TORCH_DEVICE="cpu"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


def test_native_library_is_built_from_the_port_sources():
    """libtimg_native.so comes from timg_tpu_torch/native/timg_native.cc
    alone (no libav, no libdeflate), into the port's build directory."""
    from timg_tpu_torch.native import runtime

    lib = runtime.load()
    assert lib is not None, runtime.build_error("native")
    src = runtime.source_path("native")
    assert os.path.dirname(src) == os.path.join(PORT, "native")
    assert os.path.exists(src)
    assert lib._name == runtime.lib_path("native")
    assert os.path.dirname(lib._name) == os.path.join(PORT, "native",
                                                      "build")
    assert os.path.getmtime(lib._name) >= os.path.getmtime(src)
    assert hasattr(lib, "timg_sixel_encode")
    assert not hasattr(lib, "timg_video_open")     # that is libtimg_video


@pytest.mark.parametrize("h,w,n_colors", [(12, 40, 252), (23, 37, 256),
                                          (60, 64, 17), (5, 9, 3)])
def test_c_assembler_copy_matches_timg_tpu(h, w, n_colors):
    """Seeded planes (flat runs, noise, indices past the palette): the
    port's C assembler copy == timg_tpu's encode_sixel_stream, and the
    port's Python twin == timg_tpu's.  (The two assemblers of timg_tpu
    itself disagree on the 256-color case, so the port's C copy is held
    to timg_tpu's C assembler and its twin to timg_tpu's twin.)"""
    from timg_tpu.render.sixel_render import \
        encode_sixel_stream as jax_encode
    from timg_tpu.render.sixel_render import \
        encode_sixel_stream_py as jax_encode_py
    from timg_tpu_torch.render import sixel_render

    rng = np.random.default_rng(h * w + n_colors)
    pal = rng.integers(0, 256, (n_colors, 3), dtype=np.uint8)
    idx = rng.integers(0, min(n_colors + 4, 256), (h, w)).astype(np.uint8)
    idx[: h // 2, : w // 3] = 1                      # a flat run
    before = dict(sixel_render.ASSEMBLED)
    got = sixel_render.encode_sixel_stream(idx, pal)
    assert sixel_render.ASSEMBLED["c"] == before["c"] + 1
    assert sixel_render.ASSEMBLED["python"] == before["python"]
    assert got == jax_encode(idx, pal)
    assert sixel_render.encode_sixel_stream_py(idx, pal) == \
        jax_encode_py(idx, pal)


def test_fast_path_loads_no_torch_numpy_or_jax():
    """The host fast path's modules, imported under `python -S` as the
    launcher imports them, bring in none of torch, numpy, jax or the JAX
    package."""
    code = (f"import sys; sys.path.insert(0, {REPO!r})\n"
            "import timg_tpu_torch.fast\n"
            "import timg_tpu_torch.args, timg_tpu_torch.term\n"
            "import timg_tpu_torch.native.runtime\n"
            "import timg_tpu_torch.render.png_core\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('torch', 'numpy')!r})\n"
            "print(','.join(bad))\n")
    proc = subprocess.run([sys.executable, "-S", "-c", code],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


def test_c_launcher_is_the_ports_own():
    """timg-tpu-torch-fast's sources are the port's: they include nothing
    of the JAX package, and the binary execs the port's launcher."""
    import re

    native = os.path.join(PORT, "native")
    for name in ("timg_fast_main.cc", "timg_still.cc", "timg_native.cc",
                 "css3_colors.inc"):
        with open(os.path.join(native, name)) as f:
            text = f.read()
        includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)', text,
                              re.M)
        assert not [i for i in includes if "timg_tpu/" in i
                    or i in ("libdeflate.h", "zlib.h")], (name, includes)
    with open(os.path.join(native, "timg_fast_main.cc")) as f:
        text = f.read()
    execs = re.findall(r'script = std::string\(self\) \+ "(/[^"]+)"', text)
    assert execs == ["/timg-tpu-torch"]
    assert os.path.exists(os.path.join(REPO, "timg-tpu-torch"))
