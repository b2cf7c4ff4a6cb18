"""CPU tests of the benchmark harness; tests marked ``card`` need a CUDA
card and skip without one.

    python -m pytest gsbench/tests -q

The card tests run on the chip machine with the same command.
"""

import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"
for path in (str(ROOT), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def make_root(path: Path) -> Path:
    """A checkout's root for the tiny cells: the test manifest and data
    files of ``data/`` beside the benchmark's own drivers, scenes and
    metric readers."""
    for kind in ("drivers", "scenes", "metrics"):
        shutil.copytree(BENCH / kind, path / "gsbench" / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(DATA, path, dirs_exist_ok=True)
    return path


@pytest.fixture
def root(tmp_path):
    return make_root(tmp_path / "root")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip when there is none (decided here, at run
    time, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
