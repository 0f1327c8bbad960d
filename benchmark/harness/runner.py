"""One run of one cell: set-up, warm-up, the measured window, the check,
the metrics, and one JSON line on standard output.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from host spans and one
torch.profiler session over the window's first ``TRACE_SECONDS``.  The compared numbers close
both the line (key ``check``, last) and standard error.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from harness import check, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "timg_tpu")
# a traced run profiles the first seconds of its window: reading a whole
# window's trace would take minutes
TRACE_SECONDS = 20.0


def process_start_ns() -> int:
    """This process's start on the perf_counter_ns clock (the kernel's
    start time, in clock ticks since boot, against /proc/uptime)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter_ns() - int(age * 1e9)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def say(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


class Reading:
    """What a metric's reader reads: the cell, the run, the window,
    and in a traced run the device trace and the host spans."""

    def __init__(self, cell, run, window, setup_s, trace, spans):
        self.cell, self.run = cell, run
        self.t0, self.t1 = window
        self.seconds = (self.t1 - self.t0) / 1e9
        self.setup_s = setup_s
        self.trace, self.spans = trace, spans
        self.frames = run.attempted_between(self.t0, self.t1)


def build_program(on_card: bool) -> None:
    """The kernel library (nvcc) and the native helper (g++), side by
    side; each is cached in the checkout and built only when missing or
    stale."""
    from timg_tpu_torch.native import runtime

    with ThreadPoolExecutor(2) as ex:
        kernels = None
        if on_card:
            from timg_tpu_torch.ops import _build
            kernels = ex.submit(_build.load)
        native = ex.submit(runtime.load)
        if kernels is not None:
            kernels.result()
        if native.result() is None:
            say("the native helper did not build: "
                + str(runtime.build_error("native"))[-400:])


def python_twin_frames() -> int:
    from timg_tpu_torch.render import ansi
    return ansi.EMITTED["python"]


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(args, cell, started_ns: int, on_card: bool = True) -> dict:
    """The run; returns the result line's object."""
    import torch

    traced = bool(args.trace)
    build_program(on_card)
    kind = importlib.import_module("harness." + cell.traffic["kind"])
    run = kind.Run(cell.config, cell.traffic, args.seed)
    run.setup()
    run.warm()
    spans = trace = None
    if traced:
        from harness.spans import Spans, declared
        from harness.trace import DeviceTrace
        points, ranges = declared(
            spec.metric_module(m["name"]) for m in cell.per_layer)
        spans = Spans(points, ranges)
        spans.install()
        trace = DeviceTrace(on_card, ranges)
        trace.start()
    if trace is None:
        window = run.window(args.seconds)
    else:
        window = run.window(min(args.seconds, TRACE_SECONDS))
        trace.stop(*window)
        # the rest of the window, untraced: the same work for the check
        run.window(args.seconds - (window[1] - window[0]) / 1e9)
    setup_s = (window[0] - started_ns) / 1e9
    drained = run.drain(60.0)
    if spans is not None:
        spans.restore()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    twin = python_twin_frames()
    if twin:
        say(f"{twin} frames came from the program's Python twin of its C "
            "emitter: another path than the one measured")
    unwritten = run.unanswered()
    if not drained:
        say(f"{unwritten} answers not written a minute after the window")
    run.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    reading = Reading(cell, run, window, setup_s, trace, spans)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.metric_module(m["name"]).read(reading)
        if value is None:
            if not traced:
                raise RuntimeError(f"no reading of {m['name']}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    t_ref = time.perf_counter()
    compared, numbers = check.numbers(run, unwritten, twin)
    t_ref = time.perf_counter() - t_ref
    correct = all(n["value"] <= n["limit"] for n in numbers.values())
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": run.attempted(),
              "failed": unwritten + numbers["mismatched"]["value"],
              "metrics": metrics, "device": device}
    if trace is not None:
        from harness.trace import idle_by_span
        device["busy_s"] = trace.busy_s()
        device["window_s"] = reading.seconds
        ops = sorted(trace.by_name.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle_by_span(trace, spans)[:10]]}
    for name, value in run.notes().items():
        say(f"{name}: {value}")
    t0 = window[0]
    slices = [run.answered_between(t0 + i * 10**9, t0 + (i + 1) * 10**9 - 1)
              for i in range(int(reading.seconds))]
    say(f"answers in each second of the window: {slices}")
    say(f"compared {compared} sampled answers with the reference "
        f"({t_ref:.1f} s)")
    result["check"] = numbers
    return result


def main(argv=None, on_card: bool = True) -> int:
    """``on_card=False`` skips the look for a card and runs the program
    on the CPU (the benchmark's own tests)."""
    started_ns = process_start_ns()
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    if on_card:
        import torch
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            say(f"needs {cell.chips} CUDA device(s); torch "
                f"{torch.__version__} sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        if os.environ.get("TIMG_TPU_TORCH_DEVICE", "cuda") != "cuda":
            say("TIMG_TPU_TORCH_DEVICE asks for another device than cuda")
            return 2
    result = run_cell(args, cell, started_ns, on_card)
    found = forbidden_modules()
    if found:
        say("loaded, and must not be: " + ", ".join(found))
        return 3
    for name, n in result["check"].items():
        say(f"check {name} {n['value']} (limit {n['limit']})")
    print(json.dumps(result), flush=True)
    return 0
