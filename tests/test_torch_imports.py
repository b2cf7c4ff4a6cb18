"""The PyTorch port, ``chip_smoke.py`` and the scripts and tests that run on
the card import nothing of JAX, flax or the gstpu package, and the smoke
script refuses to run without a CUDA card."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import gstpu_torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "gstpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        gstpu_torch.__path__, prefix="gstpu_torch."))


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_no_jax_flax_or_gstpu():
    mods = ["gstpu_torch"] + _modules()
    for name in ("ops.cuda_rasterize", "ops.preprocess_bwd", "ops.losses",
                 "optim", "scheduler", "models.gaussians", "trainer",
                 "ops.cuda_build", "data.nerf", "ops.kernel_check",
                 "sol_model", "bench", "bench_suite", "densify",
                 "data.colmap", "train", "utils.image", "eval_model",
                 "render_turntable", "parallel", "parallel.mesh",
                 "parallel.multihost", "parallel.collectives",
                 "parallel.sharded", "utils.tracing"):
        assert f"gstpu_torch.{name}" in mods, name
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(n for n in sys.modules if any(n == f or "
            f"n.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_name_no_jax_flax_or_gstpu_import():
    files = sorted((ROOT / "gstpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]
    for name in ("sol_model.py", "bench.py", "bench_suite.py",
                 "ops/kernel_check.py", "ops/cuda_build.py", "data/nerf.py",
                 "densify.py", "data/colmap.py", "train.py", "utils/image.py",
                 "eval_model.py", "render_turntable.py", "parallel/mesh.py",
                 "parallel/multihost.py", "parallel/collectives.py",
                 "parallel/sharded.py"):
        assert ROOT / "gstpu_torch" / name in files, name
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
