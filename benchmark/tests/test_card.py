"""A short run of every cell on the card, as the driver starts one.
Marked ``cuda``: it skips where torch sees no card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from harness import spec

CELLS = [w["name"] for w in spec.load_json(spec.SPEC_PATH)["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(name, trace, card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2**31 + 11), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "check"
    if trace:
        assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
        assert any(k.startswith("device_idle_pct") for k in result["metrics"])
