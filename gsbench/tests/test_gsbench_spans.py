"""The device's work put down to the program's spans (``harness/spans.py``)
on a hand-written Chrome trace, and the new readers in a traced CPU run of
the tiny view cell."""

import gzip
import json
import os
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import DATA, make_root
from harness import spans, trace
import run

NEW = {"inputs_ms_per_frame.view": ("ms", "lower", "device_trace", "render inputs"),
       "preprocess_ms_per_frame.view": ("ms", "lower", "device_trace", "preprocess"),
       "binning_ms_per_frame.view": ("ms", "lower", "device_trace", "binning and cull"),
       "composite_ms_per_frame.view": ("ms", "lower", "device_trace",
                                       "table, work order, K1"),
       "pair_fill_pct.view": ("%", "higher", "program_counter", "binning and cull")}


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _write(path, events):
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return path


EVENTS = [
    _x("user_annotation", trace.WINDOW, 0, 200),
    _x("user_annotation", "gstpu.outer", 10, 90),
    _x("user_annotation", "gstpu.inner", 20, 30),
    _x("user_annotation", "gstpu.other", 120, 30),
    _x("user_annotation", "gstpu.backward.composite", 150, 40, tid=2),
    _x("cpu_op", "aten::mul", 14, 3),
    _x("cuda_runtime", "cudaLaunchKernel", 15, 1, correlation=1),    # outer
    _x("cuda_runtime", "cudaLaunchKernel", 25, 1, correlation=2),    # inner
    _x("cuda_runtime", "cudaLaunchKernel", 105, 1, correlation=3),   # no span
    _x("cuda_runtime", "cudaLaunchKernel", 130, 1, correlation=4),   # other
    _x("cuda_runtime", "cudaMemcpyAsync", 160, 1, tid=2, correlation=5),
    _x("kernel", "k_outer", 30, 10, correlation=1),
    _x("kernel", "k_inner", 60, 20, correlation=2),
    _x("kernel", "k_free", 110, 5, correlation=3),
    _x("kernel", "k_other", 130, 10, correlation=4),
    _x("gpu_memcpy", "Memcpy DtoH", 160, 10, correlation=5),
    _x("kernel", "k_unknown", 180, 5, correlation=6),               # no launch
]


def test_kernels_go_to_the_innermost_span_on_the_launching_thread(tmp_path):
    s = spans.read(_write(tmp_path / "t.json.gz", EVENTS))
    us = pytest.approx
    assert s.device_s == {"outer": us(10e-6), "inner": us(20e-6), "other": us(10e-6),
                          "backward.composite": us(10e-6)}
    assert s.device_incl_s == {"outer": us(30e-6), "inner": us(20e-6),
                               "other": us(10e-6), "backward.composite": us(10e-6)}
    assert s.host_s == {"outer": us(60e-6), "inner": us(30e-6), "other": us(30e-6),
                        "backward.composite": us(40e-6)}
    assert s.unspanned_s == us(10e-6) and s.device_total_s == us(60e-6)
    assert s.idle_s == {"outer": us(30e-6), "inner": us(20e-6),
                        spans.UNSPANNED: us(30e-6), "other": us(15e-6),
                        "backward.composite": us(20e-6), spans.NO_LAUNCH: us(10e-6),
                        spans.WINDOW_END: us(15e-6)}
    t = trace.read(tmp_path / "t.json.gz")
    assert sum(s.idle_s.values()) + t.busy_s == us(t.window_s)


def test_a_trace_without_spans_reads_as_nothing(tmp_path):
    events = [e for e in EVENTS if not e["name"].startswith(spans.PREFIX)]
    assert spans.read(_write(tmp_path / "t.json.gz", events)) is None


def test_the_runs_trace_is_found_by_its_seed(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    runner = SimpleNamespace(seed=41, t0=time.perf_counter(), kind="view",
                             trace=object(), traced_items=2)
    assert spans.path_of(runner) is None
    assert spans.ms_per_item(runner, "view", "inner") is None
    old = _write(tmp_path / "gsbench_cell_41.json.gz", EVENTS)
    os.utime(old, (time.time() - 3600,) * 2)      # written before the run
    _write(tmp_path / "gsbench_cell_141.json.gz", EVENTS)
    assert spans.path_of(runner) is None
    _write(tmp_path / "gsbench_other_41.json.gz", EVENTS)
    assert spans.path_of(runner) == tmp_path / "gsbench_other_41.json.gz"
    assert spans.ms_per_item(runner, "view", "outer") == pytest.approx(30e-3 / 2)
    assert spans.ms_per_item(runner, "view", "absent") == 0.0
    assert spans.ms_per_item(runner, "train", "outer") is None


def _bench_with_new_metrics(cell):
    bench = json.loads((DATA / "BENCHMARK.json").read_text())
    for name, (unit, better, source, layer) in NEW.items():
        bench["per_layer"].append({"name": name, "unit": unit, "better": better,
                                   "source": source, "layer": layer,
                                   "moves": "frame_ms", "workloads": [cell]})
    return bench


def test_every_new_reader_reads_a_traced_cpu_run(tmp_path, monkeypatch):
    from gstpu_torch.utils import tracing

    root = make_root(tmp_path / "root")
    (root / "BENCHMARK.json").write_text(json.dumps(_bench_with_new_metrics("tiny-view")))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tracing, "TRACED", {})
    args = run.parse(["--workload", "tiny-view", "--seed", "2300000017",
                      "--seconds", "0.3", "--trace", "1"])
    result = run.execute(args, root=root, device=torch.device("cpu"))
    assert result["correct"]
    for name in NEW:
        value = result["metrics"][name]["value"]
        assert isinstance(value, float), name
    # no device on the CPU: the spans are there, with no device time
    assert result["metrics"]["binning_ms_per_frame.view"]["value"] == 0.0
    assert 0.0 < result["metrics"]["pair_fill_pct.view"]["value"] <= 100.0


def test_the_readers_read_nothing_of_a_program_without_spans(tmp_path, monkeypatch):
    """The parent's program has no tracing module and no spans: the new
    readers return None and the line leaves their metrics out."""
    import gstpu_torch.utils
    from gstpu_torch.utils import tracing

    root = make_root(tmp_path / "root")
    (root / "BENCHMARK.json").write_text(json.dumps(_bench_with_new_metrics("tiny-view")))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tracing, "span", lambda name: tracing._OFF)
    monkeypatch.delattr(gstpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "gstpu_torch.utils.tracing", None)
    args = run.parse(["--workload", "tiny-view", "--seed", "2300000019",
                      "--seconds", "0.3", "--trace", "1"])
    result = run.execute(args, root=root, device=torch.device("cpu"))
    assert result["correct"]
    assert not set(NEW) & set(result["metrics"])
    assert "pairs_per_frame.view" in result["metrics"]
