"""Every file of the JAX package has its counterpart in the port.

Each .py, .cc and .inc file and the Makefile under timg_tpu/ has a file
at the mirrored path under timg_tpu_torch/, or a named stand-in: the
Pallas modules' hand-written CUDA kernels, the numpy mirrors' plain
PyTorch versions, the Makefile's builder, and for the slim boot the
launcher's re-exec with site.  Every kernel stand-in names the tests
that hold it to the JAX kernel (on the CPU, through its plain version)
and to its plain version (on the card).  There is no exception list: a
file of timg_tpu/ without either fails.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(REPO, "timg_tpu")
PORT = os.path.join(REPO, "timg_tpu_torch")
KINDS = (".py", ".cc", ".inc")

# JAX file -> (stand-ins in the port, "file.py::function" each, and the
# parity tests, "tests/file.py::test_name" each)
STAND_INS = {
    "ops/resize_pallas.py": (
        ["csrc/resize_words.cu", "csrc/resize_passes.cu",
         "ops/resize.py::resize_video_words_plain"],
        ["tests/test_torch_ops.py::test_resize_video_words_matches_jax",
         "tests/test_torch_kernels.py::test_resize_kernel_matches_plain",
         "tests/test_torch_kernels.py::test_resize_passes_match_plain"]),
    "ops/sixel_pallas.py": (
        ["csrc/fs_dither_cube.cu", "ops/sixel_kernel.py::"
         "fs_dither_cube_rgb_plain"],
        ["tests/test_torch_models.py::"
         "test_k9_plain_matches_pallas_interpret_and_numpy",
         "tests/test_torch_kernels.py::test_cube_rgb_kernel_matches_plain"]),
    "ops/sixel_pallas3.py": (
        ["csrc/fs_dither_cube.cu", "csrc/bucket_tables.cu",
         "ops/sixel_kernel.py::fs_dither_cube_plain",
         "ops/sixel_kernel.py::fs_dither_tree_plain",
         "ops/libsixel_kernel.py::fs_dither_table_plain",
         "ops/libsixel_kernel.py::build_bucket_tables_plain"],
        ["tests/test_torch_ops.py::test_fs_dither_cube_matches_pallas_"
         "interpret",
         "tests/test_torch_dither.py::test_tree_dither_matches_jax",
         "tests/test_torch_dither.py::test_table_dither_matches_jax_and_lsq",
         "tests/test_torch_dither.py::test_bucket_tables_match_jax_and_lsq",
         "tests/test_torch_kernels.py::test_dither_kernel_matches_plain",
         "tests/test_torch_kernels.py::test_tree_kernel_matches_plain",
         "tests/test_torch_kernels.py::test_table_kernel_matches_plain",
         "tests/test_torch_kernels.py::test_bucket_kernel_matches_plain"]),
    "ops/cpu_mirror.py": (
        ["ops/blocks.py::quarter_blocks_plain",
         "ops/blocks.py::half_blocks_plain",
         "ops/compose.py::alpha_compose_background"],
        ["tests/test_torch_blocks.py", "tests/test_torch_stills.py"]),
    "_fullboot.py": (
        ["../timg-tpu-torch"],    # the launcher's re-exec with site
        ["tests/test_torch_serve.py::"
         "test_cli_run_imports_sitecustomize_before_torch",
         "tests/test_torch_serve.py::"
         "test_launcher_falls_back_when_server_absent"]),
    "native/Makefile": (
        ["native/runtime.py::load", "native/runtime.py::load_video",
         "native/runtime.py::load_still",
         "native/runtime.py::build_launcher"],
        ["tests/test_torch_isolation.py", "tests/test_torch_fastpath.py",
         "tests/test_torch_fastlauncher.py"]),
}
KERNEL_STAND_INS = ("ops/resize_pallas.py", "ops/sixel_pallas.py",
                    "ops/sixel_pallas3.py")


def _jax_files():
    out = []
    for root, _, files in os.walk(JAX):
        for f in files:
            if f.endswith(KINDS) or f == "Makefile":
                out.append(os.path.relpath(os.path.join(root, f), JAX))
    return sorted(out)


def _defined(path: str, name: str) -> bool:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return any(isinstance(n, (ast.FunctionDef, ast.ClassDef))
               and n.name == name for n in ast.walk(tree))


def _exists(root: str, ref: str) -> bool:
    """``file`` or ``file::name`` (a function or class it defines)."""
    path, _, name = ref.partition("::")
    path = os.path.join(root, path)
    return os.path.isfile(path) and (not name or _defined(path, name))


@pytest.mark.parametrize("rel", _jax_files())
def test_every_jax_file_has_a_counterpart(rel):
    if os.path.exists(os.path.join(PORT, rel)):
        assert rel not in STAND_INS, f"{rel} has its twin: drop its stand-in"
        return
    assert rel in STAND_INS, f"timg_tpu/{rel} has no counterpart in the port"
    stand_ins, tests = STAND_INS[rel]
    missing = [s for s in stand_ins if not _exists(PORT, s)]
    missing += [t for t in tests if not _exists(REPO, t)]
    assert not missing, missing


def test_kernel_stand_ins_name_their_parity_tests():
    """Each Pallas module's stand-in is a CUDA kernel held by a test on
    the card (test_torch_kernels.py) and, through its plain version, by
    a test against the JAX kernel on the CPU."""
    for rel in KERNEL_STAND_INS:
        stand_ins, tests = STAND_INS[rel]
        assert any(s.startswith("csrc/") and s.endswith(".cu")
                   for s in stand_ins), rel
        assert any(t.startswith("tests/test_torch_kernels.py::")
                   for t in tests), rel
        assert any(not t.startswith("tests/test_torch_kernels.py")
                   for t in tests), rel


def test_every_pallas_module_is_a_kernel_stand_in():
    """A module of timg_tpu that reaches pl.pallas_call and has no twin
    is listed among the kernel stand-ins."""
    for rel in _jax_files():
        if not rel.endswith(".py") or os.path.exists(os.path.join(PORT,
                                                                  rel)):
            continue
        with open(os.path.join(JAX, rel)) as f:
            if "pallas_call" in f.read():
                assert rel in KERNEL_STAND_INS, rel
