"""``timg-tpu-torch --version`` (timg_tpu_torch/version.py) against the
JAX package's rows (timg_tpu/version.py): the same rows in the same
order, the jax row replaced by torch, CUDA and the card(s), plus the
kernel library's row; and no compiler started."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
os.environ["TIMG_TPU_TORCH_DEVICE"] = "cpu"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS_ROW = "CUDA kernels: timg_tpu_torch/csrc/build/"


def _rows(module, capsys):
    capsys.readouterr()
    assert module.print_component_versions() == 0
    return capsys.readouterr().out.splitlines()


def test_rows_follow_the_jax_package(capsys):
    import timg_tpu.version as jax_version
    import timg_tpu_torch.version as port_version

    theirs = _rows(jax_version, capsys)
    ours = _rows(port_version, capsys)
    kernels = [r for r in ours if r.startswith(KERNELS_ROW)]
    assert len(kernels) == 1
    assert kernels[0].split(" ", 3)[-1] in (
        "missing (built at first use)", "stale (rebuilt at first use)",
        "built and fresh")
    ours = [r for r in ours if not r.startswith(KERNELS_ROW)]
    assert len(ours) == len(theirs)
    assert ours[0].startswith("timg-tpu-torch ")
    assert theirs[0].startswith("timg-tpu ")
    assert ours[2] == theirs[2] == ""
    # the framework row: torch, CUDA and the card(s) for jax's
    assert theirs[3].startswith("jax ")
    assert ours[3].startswith("torch ")
    import torch
    if torch.cuda.is_available():
        assert f"({torch.cuda.device_count()} device(s))" in ours[3]
    else:
        assert ours[3].endswith("; CUDA not available")
    native = 6
    assert ours[native].startswith("native runtime: ")
    assert theirs[native].startswith("native runtime: ")
    for i, (a, b) in enumerate(zip(ours, theirs)):
        if i not in (0, 1, 3, native):
            assert a == b, f"row {i}: {a!r} != {b!r}"


def test_version_starts_no_compiler(capsys, monkeypatch):
    """Stale or missing, neither the kernel library nor the native
    helper is built by --version."""
    import timg_tpu_torch.version as port_version
    from timg_tpu_torch.native import runtime
    from timg_tpu_torch.ops import _build

    started = []

    def refuse(*args, **kwargs):
        started.append(args)
        raise AssertionError(f"--version started {args!r}")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(runtime, "_handles", {})
    monkeypatch.setattr(runtime, "_fresh", lambda name: False)
    monkeypatch.setattr(_build, "_stale", lambda: True)
    rows = _rows(port_version, capsys)
    assert not started
    assert "native runtime: video decoder not built; C sixel assembler " \
           "not built; still pipeline not built" in rows
    assert any(r.startswith(KERNELS_ROW) and r.endswith(
        ("stale (rebuilt at first use)", "missing (built at first use)"))
        for r in rows)


def test_cli_version_in_a_subprocess():
    """The launcher's --version: no server involved, exit 0, the rows."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TIMG_")}
    env.update(TIMG_TPU_TORCH_DEVICE="cpu", TIMG_TPU_NO_SERVE="1")
    r = subprocess.run([sys.executable, os.path.join(REPO, "timg-tpu-torch"),
                        "--version"], env=env, capture_output=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-400:]
    out = r.stdout.decode().splitlines()
    assert out[0].startswith("timg-tpu-torch ")
    assert out[-1] == ("Half, quarter, sixel, iterm2, and kitty graphics "
                       "output: builtin.")
    assert any(row.startswith(KERNELS_ROW) for row in out)
