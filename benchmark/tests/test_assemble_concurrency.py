"""``assemble_concurrency.sixel``: the sixel assemblies in flight while
the sixel model assembles a batch, read from hand-made span lists (one
after another, four at once, none) and from a traced run of the sixel
cell on the CPU at a tiny size."""

from types import SimpleNamespace

import pytest
from test_harness import run

from harness import spec

CELL = "lib-sixel-adaptive-film-b32"
READER = "assemble_concurrency.sixel"


def _read(recs):
    from timg_tpu_torch import tracing

    tracing.clear()
    r = SimpleNamespace(t0=0, t1=1000, seconds=1000 / 1e9,
                        trace=SimpleNamespace(intervals=[]))
    tracing._records.extend(recs)
    try:
        return spec.metric_module(READER).read(r)
    finally:
        tracing.clear()


def _spans(case):
    """A batch's lib.emit [0, 400) on thread 7 and its four assemblies:
    one after another inside it, at once on four threads, or none; or
    all of them past the window."""
    from timg_tpu_torch import tracing

    Rec = tracing.Record
    emit = Rec("lib.emit", 0, 400, 0, 1, 4, 7)
    if case == "serial":
        return [emit] + [Rec("lib.assemble", 100 * k, 100 * k + 100, 1,
                             2 + k, 9, 7) for k in range(4)]
    pooled = [Rec("lib.assemble", 0, 400, 0, 2 + k, 9, 8 + k)
              for k in range(4)]
    if case == "four at once":
        return [emit] + pooled
    if case == "past the window":
        return [s._replace(t0_ns=s.t0_ns + 1000, t1_ns=s.t1_ns + 1000)
                for s in [emit] + pooled]
    return [emit]


@pytest.mark.parametrize("case,want", [("serial", 1.0),
                                       ("four at once", 4.0),
                                       ("no lib.assemble", None),
                                       ("past the window", None)])
def test_concurrency_reads_the_assemblies_in_flight(case, want):
    got = _read(_spans(case))
    assert got == (want if want is None else pytest.approx(want))


def test_traced_cpu_run_reads_at_most_the_pools_width(tiny, cpu_device):
    from timg_tpu_torch import tracing
    from timg_tpu_torch.render import sixel_render

    cell = tiny(CELL)
    cell.config.update(out_h=16, out_w=28)
    tracing.clear()
    result = run(cell, trace=1)
    tracing.clear()
    assert result["correct"], result["check"]
    got = result["metrics"][READER]
    width = min(sixel_render._host_cpus(), int(cell.config["batch"]))
    assert got["unit"] == "x"
    assert 0 < got["value"] <= width
