"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: ``gstpu_torch`` is not ``gstpu``), and the
reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gstpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not top_level_imports(path) & {"gstpu_torch", "harness", "gstpu"}, path


def test_whole_name_compared():
    assert "gstpu_torch".split(".")[0] not in FORBIDDEN


def test_run_loads_no_jax_and_refuses_without_a_card():
    code = ("import sys, runpy; sys.argv = ['run.py', '--workload', 'mip360-view', "
            "'--seed', '1', '--seconds', '1']\n"
            "import torch\n"
            "if torch.cuda.is_available(): print('CARD'); sys.exit(0)\n"
            "sys.path[:0] = [%r, %r]\n"
            "import run, gstpu_torch.trainer, gstpu_torch.render\n"
            "from harness import manifest\n"
            "for kind, name in [('drivers', 'train'), ('drivers', 'view'), "
            "('scenes', 'surfaces')]: manifest.module(kind, name)\n"
            "rc = run.main(sys.argv[1:])\n"
            "print('RC', rc, sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (str(BENCH), str(ROOT), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    if out.stdout.startswith("CARD"):
        pytest.skip("a card is present")
    assert out.stdout.strip().splitlines()[-1] == "RC 2 []", out.stdout + out.stderr
