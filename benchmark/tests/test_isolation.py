"""Nothing the benchmark runs loads jax or the JAX package (top-level
module names compared whole: timg_tpu_torch is the port), and the plain
reference loads nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "timg_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def sources(*parts):
    return glob.glob(os.path.join(BENCH, *parts), recursive=True)


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in sources("**", "*.py"):
        assert not set(imported_tops(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference", "*.py"):
        tops = set(imported_tops(path))
        assert tops <= {"__future__", "functools", "math", "typing",
                        "numpy", "reference"}, (path, tops)


def test_loaded_modules_of_a_run_and_of_the_reference():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import reference.streams\n"
        "assert not any(m.split('.')[0] in ('timg_tpu_torch', 'torch') "
        "for m in sys.modules), 'the reference loaded the program'\n"
        "from harness import runner, library, trace, spans\n"
        "import timg_tpu_torch.models, timg_tpu_torch.render.ansi\n"
        "import timg_tpu_torch.ops.pipeline\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
        % (BENCH, ROOT, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
