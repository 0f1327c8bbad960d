"""The library's sixel cell on the CPU at a tiny size: its traffic kind
builds the model with the configuration's options, the cell loads by
name and runs to a correct line, its readers read the program's spans,
its check sees each fault the sixel path can have, and its bfloat16
control mismatches."""

import io
import json
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest
from test_harness import _first_altered, _half, _stale, run
from test_units import chip_smoke_constants

import control
from harness import library, library_options, runner, spec

CELL = "lib-sixel-adaptive-film-b32"
SEED = 2**31 + 77


@pytest.fixture
def sixel(tiny):
    """The cell at a tiny size, with a height of no multiple of 6."""
    cell = tiny(CELL)
    cell.config.update(out_h=16, out_w=28)
    return cell


def test_the_cell_is_the_sixel_model_with_a_palette_a_stream():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1
    assert cell.traffic["kind"] == "library_options"
    assert cell.config["model"] == "sixel"
    assert cell.config["options"] == {"dither": "adaptive",
                                      "adaptive_reuse": True}
    assert (cell.config["out_h"], cell.config["out_w"]) == (720, 1280)
    assert cell.traffic["content"] == spec.traffic_mix("batch-film")[
        "content"]
    assert {m["name"] for m in cell.end_to_end} == {"lib_payloads_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "tree_dither_roofline.sixel", "assemble_ms_per_frame.sixel",
        "stb_resize_roofline", "h2d_ms_per_frame.lib",
        "device_idle_pct.lib", "stage_gbps.lib",
        "fetch_wait_ms_per_frame.lib", "idle_in_resize_pct.lib",
        "idle_in_emit_pct.lib", "pin_gbps.lib", "staged_pinned_pct.lib"}


def test_options_build_the_model(sixel, cpu_device):
    from timg_tpu_torch.models import SixelModel

    r = library_options.Run(sixel.config, sixel.traffic, SEED)
    r.setup()
    assert isinstance(r.model, SixelModel)
    assert r.model.dither == "adaptive" and r.model.adaptive_reuse
    assert (r.model.out_h, r.model.out_w) == (16, 28)
    assert r.model.bg_color == (0, 0, 0, 255)


def test_otherwise_driven_as_the_library_kind(tiny, cpu_device):
    """With no options, the two kinds make the same pool and return the
    same payloads, batch after batch."""
    cell = tiny("lib-quarter-film-b32")
    runs = [kind.Run(cell.config, cell.traffic, SEED)
            for kind in (library, library_options)]
    for r in runs:
        r.setup()
        r.warm()
        for _ in range(5):
            r._call(True)
    a, b = runs
    assert np.array_equal(a.pool, b.pool)
    assert b.returned == a.returned == b.first_measured + b.attempted()
    assert b.sample.chosen() == a.sample.chosen()
    assert b.notes()["payloads returned"] == b.returned


def test_runner_main_prints_a_correct_line(sixel, cpu_device, monkeypatch,
                                           capsys):
    monkeypatch.setattr(spec, "load_cell", lambda name: sixel)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = runner.main(["--workload", CELL, "--seed", str(SEED),
                          "--seconds", "1", "--trace", "0"], on_card=False)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"lib_payloads_per_s", "setup_s"}
    assert "'python': 0" in capsys.readouterr().err


def test_traced_run_reads_the_sixel_spans(sixel, cpu_device):
    from timg_tpu_torch import tracing

    tracing.clear()
    result = run(sixel, trace=1)
    assert result["correct"], result["check"]
    metrics = result["metrics"]
    assert metrics["assemble_ms_per_frame.sixel"]["value"] > 0
    assert metrics["fetch_wait_ms_per_frame.lib"]["value"] > 0
    assert metrics["stage_gbps.lib"]["value"] > 0
    # no device time on the CPU: the rooflines read nothing
    assert not any("roofline" in k for k in metrics)
    names = {r.name for r in tracing.records()}
    assert {"lib.batch", "lib.resize", "lib.dither", "lib.fetch",
            "lib.emit"} <= names
    tracing.clear()


def test_python_assembly_fails_the_run(sixel, cpu_device, monkeypatch):
    from timg_tpu_torch.native import runtime

    monkeypatch.setattr(runtime, "load", lambda: None)
    with pytest.raises(RuntimeError, match="Python twin"):
        run(sixel, seconds=0.5)


def _altered_payloads(monkeypatch):
    from timg_tpu_torch.render import sixel_render

    fn = sixel_render.encode_sixel_stream

    def altered(*args, **kwargs):
        out = bytearray(fn(*args, **kwargs))
        out[len(out) // 2] ^= 0x01
        return bytes(out)
    monkeypatch.setattr(sixel_render, "encode_sixel_stream", altered)


def _palette_a_batch(monkeypatch):
    """The tree built again for every batch: not the stream's."""
    from timg_tpu_torch.models import SixelModel

    fn = SixelModel._render_resized

    def fresh(self, x):
        self.reset_palette()
        return fn(self, x)
    monkeypatch.setattr(SixelModel, "_render_resized", fresh)


def _faults():
    from timg_tpu_torch.models import SixelModel

    return {
        "state unchanged": lambda mp: _stale(
            mp, SixelModel, "_render_resized"),
        "half the batch": lambda mp: _half(
            mp, SixelModel, "render_batch", arg=1),
        "answer altered": _altered_payloads,
        "first of each batch altered": lambda mp: _first_altered(
            mp, SixelModel, "render_batch"),
        "a palette a batch": _palette_a_batch,
    }


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch",
                                   "answer altered",
                                   "first of each batch altered",
                                   "a palette a batch"])
def test_check_fails_on_a_broken_sixel_path(fault, sixel, cpu_device,
                                            monkeypatch):
    # one warm-up batch: a short window's first batch is then no repeat
    # of the pool frames the warm-up rendered
    sixel.traffic.update(check_frames=16, warm_batches=1)
    _faults()[fault](monkeypatch)
    result = run(sixel)
    assert not result["correct"], result["check"]


def test_bf16_control_mismatches(sixel):
    bad, n = control.control(sixel, SEED, 4)
    assert n == 4 and bad == n


def test_tree_ops_are_chip_smokes():
    module = spec.metric_module("tree_dither_roofline.sixel")
    assert module.TREE_OPS_PER_PX == chip_smoke_constants()[
        "TREE_OPS_PER_PX"]


def test_tree_roofline_reads_the_byte_tree_kernel_alone():
    from harness import roofline

    module = spec.metric_module("tree_dither_roofline.sixel")
    tree = ("void (anonymous namespace)::fs_dither<(anonymous namespace)::"
            "RgbPixels, (anonymous namespace)::TreeQuant, unsigned char>"
            "(unsigned char const*, int)")
    others = [tree.replace("TreeQuant", "CubeQuant"),
              tree.replace("RgbPixels", "WordPixels"), "Memcpy DtoH"]
    by_name = {tree: 0.002, **{k: 1.0 for k in others}}
    trace = SimpleNamespace(seconds=lambda match: sum(
        v for k, v in by_name.items() if match(k)))
    r = SimpleNamespace(trace=trace, frames=64, run=SimpleNamespace(
        config={"out_h": 720, "out_w": 1280}))
    px = 64 * 720 * 1280
    want = 100 * (px * 71 / roofline.F32_OPS_PER_S) / 0.002
    assert module.read(r) == pytest.approx(want)
    assert roofline.bound_s(px * 5, px * 71)[1] == "operations"
    by_name[tree] = 0.0
    assert module.read(r) is None
