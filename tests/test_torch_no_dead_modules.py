"""Every module of timg_tpu_torch is referenced by the port, its tests,
tools, scripts, chip_smoke.py or the launcher (the counterpart of
tests/test_no_dead_modules.py): a module nothing names is dead code."""

import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "timg_tpu_torch")


def _all_py(root):
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _modules():
    return sorted(os.path.relpath(p, PORT) for p in _all_py(PORT)
                  if os.path.basename(p) != "__init__.py")


def _corpus():
    texts = []
    for root in (PORT, os.path.join(REPO, "tests"),
                 os.path.join(REPO, "tools"), os.path.join(REPO, "scripts")):
        texts += [(p, open(p, encoding="utf-8").read())
                  for p in _all_py(root)]
    for top in ("chip_smoke.py", "timg-tpu-torch"):
        path = os.path.join(REPO, top)
        texts.append((path, open(path, encoding="utf-8").read()))
    return texts


CORPUS = _corpus()


@pytest.mark.parametrize("rel", _modules())
def test_module_is_referenced(rel):
    name = os.path.splitext(os.path.basename(rel))[0]
    pat = re.compile(r"\b" + re.escape(name) + r"\b")
    own = os.path.join(PORT, rel)
    refs = [p for p, text in CORPUS if p != own and pat.search(text)]
    assert refs, f"timg_tpu_torch/{rel} is referenced nowhere"
