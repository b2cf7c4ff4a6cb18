"""Everything of a cell is found by name: the manifest (``BENCHMARK.json``)
names the cells, configurations and metrics; a configuration is the file
its entry names, and names its scene, ``gsbench/scenes/<scene>.py``; a
traffic mix is ``gsbench/traffic/<name>.json`` and names its driver,
``gsbench/drivers/<driver>.py`` (a class ``Driver``); a per-layer metric's
reader is ``gsbench/metrics/<name>.py`` (a ``read(run)`` that returns a
number or None) and a cell's limits are ``gsbench/limits/<cell>.json``.
Adding one of each is adding files."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FOLDER = "gsbench"


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(manifest: dict, name: str) -> dict:
    return _named(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(manifest["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def _data(kind: str, name: str, root: Path) -> dict:
    with open(root / FOLDER / kind / f"{name}.json") as f:
        return json.load(f)


def traffic(name: str, root: Path = ROOT) -> dict:
    return _data("traffic", name, root)


def limits(cell: str, root: Path = ROOT) -> dict:
    return _data("limits", cell, root)


def metrics(manifest: dict, cell: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones: every entry without ``workloads`` and every entry listing it."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in manifest[kind] if cell in m.get("workloads", [cell])]


def module(kind: str, name: str, root: Path = ROOT):
    """The module ``gsbench/<kind>/<name>.py``, loaded from its file."""
    path = root / FOLDER / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gsbench_{kind}_{name}", path)
    loaded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loaded)
    return loaded


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of a per-layer metric."""
    return module("metrics", name, root).read


def driver(manifest: dict, cell: str, seed: int, device, t0: float,
           root: Path = ROOT, cfg: dict | None = None):
    """A run of ``cell``: its traffic mix's driver on its configuration's
    scene (``cfg`` replaces the configuration, as a test at a smaller
    size does)."""
    entry = workload(manifest, cell)
    cfg = cfg or config(manifest, entry["config"], root)
    mix = traffic(entry["traffic"], root)
    return module("drivers", mix["driver"], root).Driver(
        cfg, mix, seed, device, t0, module("scenes", cfg["scene"], root))
