"""Whether what the timed path wrote is correct.

Once the window has closed, the payloads that the sample kept are
computed again by the plain reference (benchmark/reference)
from the same decoded frames, and compared byte for byte.  The numbers
compared, each with its limit:

- ``mismatched``: sampled answers whose bytes differ from the
  reference's (limit 0: the comparison is exact);
- ``unwritten``: payloads asked for and never answered (limit 0);
- ``python_twin``: payloads that the program's Python twin of its C
  emitter wrote (limit 0: that is another path).
"""

from __future__ import annotations

import importlib

from reference.precision import F32

LIMITS = {"mismatched": 0, "unwritten": 0, "python_twin": 0}


def expected(run, key: int, prec=F32) -> bytes:
    """The reference's bytes for answer ``key`` of ``run``: the entry
    ``module:function`` of benchmark/reference that the traffic mix
    names under ``reference``."""
    module, function = run.traffic["reference"].split(":")
    fn = getattr(importlib.import_module("reference." + module), function)
    return fn(run, key, prec)


def compare(run, answers: dict, prec=F32) -> dict:
    """key -> True where ``answers[key]`` equals the reference."""
    return {key: expected(run, key, prec) == got
            for key, got in sorted(answers.items())}


def numbers(run, unwritten: int, python_twin: int, prec=F32) -> dict:
    """(answers compared, {number: {"value", "limit"}})."""
    same = compare(run, run.sample.chosen(), prec)
    got = {"mismatched": sum(1 for ok in same.values() if not ok),
           "unwritten": unwritten, "python_twin": python_twin}
    return len(same), {name: {"value": got[name], "limit": LIMITS[name]}
                       for name in LIMITS}
