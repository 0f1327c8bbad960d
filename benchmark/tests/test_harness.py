"""The harness end to end, with the program's plain versions on the CPU,
and its check seeing each fault a cell can have."""

import numpy as np
import pytest

from conftest import CELLS
from harness import runner


def run(cell, seconds=1.5, trace=0):
    args = runner.parse(["--workload", cell.name, "--seed", str(2**31 + 7),
                         "--seconds", str(seconds), "--trace", str(trace)])
    return runner.run_cell(args, cell, runner.process_start_ns(),
                           on_card=False)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, tiny, cpu_device):
    result = run(tiny(name))
    assert result["correct"], result["check"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"]
    assert len(result["metrics"]) >= 2
    assert list(result)[-1] == "check"


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_host_metrics(name, tiny, cpu_device):
    result = run(tiny(name), trace=1)
    assert result["correct"], result["check"]
    assert result["device"]["window_s"] > 0
    assert result["breakdown"]["idle_gaps"]
    # no device time on the CPU: the device readers give nothing
    assert not any(k.startswith(("device_idle", "h2d")) or "roofline" in k
                   for k in result["metrics"])


def _stale(monkeypatch, module, attr):
    """A step that returns its first result again and again."""
    fn = getattr(module, attr)
    first = []

    def stale(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not first:
            first.append(out)
        return first[0]
    monkeypatch.setattr(module, attr, stale)


def _half(monkeypatch, module, attr, arg=0):
    """Half of each batch left out: the other half computed twice."""
    fn = getattr(module, attr)

    def half(*args, **kwargs):
        args = list(args)
        batch = args[arg]
        keep = batch[: (len(batch) + 1) // 2]
        args[arg] = (np.concatenate([keep, keep])[:len(batch)]
                     if isinstance(batch, np.ndarray)
                     else (list(keep) * 2)[:len(batch)])
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, attr, half)


def _altered(monkeypatch, module, attr):
    """An answer altered where it is produced: one byte of each."""
    fn = getattr(module, attr)

    def altered(*args, **kwargs):
        out = bytearray(fn(*args, **kwargs))
        if out:
            out[len(out) // 2] ^= 0x01
        return bytes(out)
    monkeypatch.setattr(module, attr, altered)


def _faults(name):
    """The faults a library cell can have, planted in the program."""
    from timg_tpu_torch.models import blocks as models_blocks
    from timg_tpu_torch.render import ansi

    return {
        "state unchanged": lambda mp: _stale(
            mp, models_blocks._BlockModel, "process_batch"),
        "half the batch": lambda mp: _half(
            mp, models_blocks._BlockModel, "process_batch", arg=1),
        "answer altered": lambda mp: _altered(
            mp, ansi, "_emit_frame_native"),
        "first of each batch altered": lambda mp: _first_altered(
            mp, models_blocks._BlockModel, "render_batch"),
    }


def _first_altered(monkeypatch, module, attr):
    """One position of the batch at fault: the first payload's bytes."""
    fn = getattr(module, attr)

    def first_altered(*args, **kwargs):
        out = list(fn(*args, **kwargs))
        head = bytearray(out[0])
        head[len(head) // 2] ^= 0x01
        out[0] = type(out[0])(head)
        return out
    monkeypatch.setattr(module, attr, first_altered)


FAULTS = [(cell, fault) for cell in CELLS for fault in
          ("state unchanged", "half the batch", "answer altered",
           "first of each batch altered")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_check_fails_on_a_broken_path(name, fault, tiny, cpu_device,
                                      monkeypatch):
    cell = tiny(name)
    cell.traffic["check_frames"] = 16
    _faults(name)[fault](monkeypatch)
    result = run(cell)
    assert not result["correct"], result["check"]
