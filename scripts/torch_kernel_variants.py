#!/usr/bin/env python3
"""Ablations of the compositing kernels K1 and K2 on a CUDA card.

    python3 scripts/torch_kernel_variants.py [--previous DIR] [--out PATH]

Builds variants of ``gstpu_torch/csrc/rasterize_fwd.cu`` (K1) and
``rasterize_bwd.cu`` (K2) that differ from the sources in one design
constant each (the line is replaced; a line not found raises), with the
flags of ``ops/cuda_build.py``.  A variant keeps the source's C interface,
so the wrappers of ``ops/cuda_rasterize.py`` launch it in place of the
source (``launching``), and ``chip_smoke.bare_ms`` times the bare launch
(20 back to back per CUDA-event pair, median of 5) on the shapes of
``chip_smoke.py``:

- K1 at the 800x800 Lego orbit view (theta = 0) and the close view: the
  pixels per CTA (64, the source; 32, 128, 256) and the alphas computed
  ahead of the serial chain (8, the source; 1, 2, 4); the tiles in index
  order in place of deepest first (``index_order``); with checkpoints
  every ``cuda_rasterize.SEGMENT`` pairs; the deepest tile alone.  Every
  variant's outputs must be bit-identical to the source's.
- K2 at the training step's view (the perturbed trained Lego of
  ``chip_smoke.TrainRun``, view 2): pairs per batch (64, the source; 32,
  128), a launch bound asking for 4, 5 or 6 CTAs per SM, and the work items
  (whole tiles, or segments of 256, 512 and 1,024 pairs from K1's
  checkpoints, with ``cuda_rasterize.SEGMENT`` set for the call:
  ``segment``).  Rows from checkpoints of 256 pairs must be bit-identical
  across the variants.
- The wrappers' own cost (one call per CUDA-event pair, median of 20):
  building the work list, and each wrapper.

With ``--previous DIR`` (the parent commit's files, as ``chip_smoke.py
--previous`` takes them: ``chip_smoke.PreviousKernels``) the parent's
kernels are timed the same way, through the parent's wrappers.  Prints one
JSON line per measurement (with ptxas's registers and spills per variant)
and writes them to ``--out``.  Imports nothing of JAX or of gstpu.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gstpu_torch import scenes  # noqa: E402
from gstpu_torch.config import RenderSettings  # noqa: E402
from gstpu_torch.ops import cuda_build  # noqa: E402
from gstpu_torch.ops import cuda_rasterize as CR  # noqa: E402
from gstpu_torch.ops import rasterize as R  # noqa: E402
from gstpu_torch.render import default_pair_capacity  # noqa: E402

OUT_DIR = cuda_build.BUILD_DIR / "variants"
K1_GROUP = "constexpr int kGroupPixels = 64;"
K1_AHEAD = "constexpr int kAhead = 8;"
K2_BATCH = "constexpr int kBatch = 64;"
K2_BOUND = "__global__ void __launch_bounds__(kPixels)\nrasterize_bwd_kernel"
K1_VARIANTS = {
    "source (64 pixels, 8 ahead)": {},
    **{f"{g} pixels per CTA": {K1_GROUP: f"constexpr int kGroupPixels = {g};"}
       for g in (32, 128, 256)},
    **{f"{a} ahead": {K1_AHEAD: f"constexpr int kAhead = {a};"}
       for a in (1, 2, 4)},
}
K2_VARIANTS = {
    "source (batch 64, no CTA bound)": {},
    **{f"batch {b}": {K2_BATCH: f"constexpr int kBatch = {b};"}
       for b in (32, 128)},
    **{f"at least {m} CTAs per SM": {K2_BOUND: K2_BOUND.replace(
        "(kPixels)", f"(kPixels, {m})")} for m in (4, 5, 6)},
}
# K2's segment lengths, the source's SEGMENT first
SEGMENTS = (256, 512, 1024)
RECORDS = []


def log(**kw) -> None:
    RECORDS.append(kw)
    print(json.dumps(kw), flush=True)


@contextlib.contextmanager
def launching(kernel: str, fn):
    """Within the block the wrappers launch ``fn`` (a variant's launch
    function, the source's C interface) in place of the source's."""
    lib = CR._library(kernel)
    name = f"gstpu_{kernel}"
    source = getattr(lib, name)
    setattr(lib, name, fn)
    try:
        yield lib
    finally:
        setattr(lib, name, source)


@contextlib.contextmanager
def index_order():
    """Within the block K1's wrapper hands the tiles in index order, not
    deepest first (for K1 without checkpoints, whose work list has no
    segments)."""
    build = CR.build_work_list

    def in_index_order(tile_count, pair_slots, segment=CR.WHOLE_TILE):
        work = build(tile_count, pair_slots, segment)
        return work._replace(order=torch.arange(
            len(work.order), dtype=torch.int32, device=work.order.device))

    CR.build_work_list = in_index_order
    try:
        yield
    finally:
        CR.build_work_list = build


@contextlib.contextmanager
def segment(length: int):
    """Within the block K1 checkpoints every ``length`` pairs."""
    source = CR.SEGMENT
    CR.SEGMENT = length
    try:
        yield
    finally:
        CR.SEGMENT = source


def build(kernel: str, variants: dict) -> dict:
    """{variant: loaded library}, every variant built at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = (cuda_build.CSRC / f"{kernel}.cu").read_text()
    procs = []
    for i, (name, subs) in enumerate(variants.items()):
        text = src
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"{kernel}: no line {old!r} to vary")
            text = text.replace(old, new)
        path = OUT_DIR / f"{kernel}_{i}.cu"
        path.write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
               str(cuda_build.CSRC), "-o", str(path.with_suffix(".so")),
               str(path)]
        procs.append((name, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, path, proc in procs:
        out, _ = proc.communicate()
        log(kernel=kernel, variant=name, returncode=proc.returncode,
            ptxas=[line.strip() for line in out.splitlines()
                   if "Used" in line or "spill" in line])
        if proc.returncode != 0:
            raise RuntimeError(f"{kernel} variant {name!r} did not build")
        lib = ctypes.CDLL(str(path.with_suffix(".so")))
        fn = getattr(lib, f"gstpu_{kernel}")
        fn.argtypes = getattr(CR._library(kernel), f"gstpu_{kernel}").argtypes
        libs[name] = fn
    return libs


def k1_variants(libs, previous, params, dev) -> None:
    n = params["positions"].shape[0]
    s = RenderSettings(width=800, height=800,
                       pair_capacity=default_pair_capacity(n))
    fname = "gstpu_rasterize_fwd"
    for view, cam in (("orbit theta=0", scenes.lego_orbit(0.0, 800)),
                      ("close", scenes.lego_close_view(800))):
        prep, pairs = cs.prep_and_pairs(params, cam, s)
        deep = cs.only_deepest(pairs)
        ref = None
        for name, fn in libs.items():
            with launching("rasterize_fwd", fn) as lib:
                def ms(pairs=pairs, forward=CR.composite_forward):
                    return cs.bare_ms(lib, fname,
                                      lambda: forward(prep, pairs, s))
                bits = [x.clone() for x in CR.composite_forward(prep, pairs,
                                                                s)]
                ref = ref or bits
                res = {"bit_identical_to_source": cs.bits_equal(bits, ref),
                       "ms": ms(), "deepest_tile_ms": ms(deep)}
                if name.startswith("source"):
                    with index_order():
                        res["index_order_ms"] = ms()
                    res["checkpoints_ms"] = ms(
                        forward=CR.composite_forward_checkpointed)
            log(kernel="K1", view=view, variant=name, **res)
            if not res["bit_identical_to_source"]:
                raise RuntimeError(f"K1 variant {name!r} changed the outputs")
        if previous is not None:
            plib = previous.libs["rasterize_fwd"]
            p_forward = previous.module.composite_forward
            log(kernel="K1", view=view, variant="parent", **{
                key: cs.bare_ms(plib, fname, lambda p=p: p_forward(prep, p, s))
                for key, p in (("ms", pairs), ("deepest_tile_ms", deep))})
        log(view=view, k1_wrapper_ms=cs.time_ms(
            lambda: CR.composite_forward(prep, pairs, s), 20),
            k1_wrapper_checkpoints_ms=cs.time_ms(
                lambda: CR.composite_forward_checkpointed(prep, pairs, s), 20),
            work_list_ms=cs.time_ms(lambda: CR.build_work_list(
                pairs.tile_count, pairs.gauss_id.shape[0], CR.SEGMENT), 20))


def k2_variants(libs, previous, dev) -> None:
    run = cs.TrainRun(800, dev)
    view, proj, campos, tanx, tany, target = run.view_args(2)
    s = run.settings
    p = run.model.param_dict()
    with torch.no_grad():
        (image, _, aux), (prep, pairs, color, dacc, _) = R._render_fwd(
            s, tanx, tany, run.cfg.scale_modifier, p["positions"],
            p["scales"], p["rotations"], p["opacities"], p["shs"], view,
            proj, campos, run.bg, run.model.alive, 0,
            CR.composite_forward_checkpointed)
    dl_dpix = R.image_to_tiles(cs.l1_pixel_gradients(image, target), s)
    inputs = dict(color_pre_bg=color, final_t=aux.final_t, dl_dpix=dl_dpix,
                  bg=run.bg, depth_acc=dacc,
                  dl_ddepth=torch.zeros_like(aux.final_t))
    ckpts = {None: None}
    for length in SEGMENTS:
        with segment(length):
            ckpts[length] = CR.composite_forward_checkpointed(prep, pairs,
                                                              s)[4]
    fname = "gstpu_rasterize_bwd"
    ref = None
    for name, fn in libs.items():
        res = {}
        with launching("rasterize_bwd", fn) as lib:
            for length, ckpt in ckpts.items():
                res[f"segment {length or 'whole tile'} ms"] = cs.bare_ms(
                    lib, fname, lambda c=ckpt: CR.backward_rows(
                        prep, pairs, s, **inputs, checkpoints=c))
            rows = CR.backward_rows(prep, pairs, s, **inputs,
                                    checkpoints=ckpts[SEGMENTS[0]])
        ref = rows if ref is None else ref
        res["rows_bit_identical_to_source"] = bool(torch.equal(
            rows.view(torch.int32), ref.view(torch.int32)))
        log(kernel="K2", view="train step view 2", variant=name, **res)
        if not res["rows_bit_identical_to_source"]:
            raise RuntimeError(f"K2 variant {name!r} changed the rows")
    if previous is not None:
        log(kernel="K2", view="train step view 2", variant="parent",
            ms=cs.bare_ms(previous.libs["rasterize_bwd"], fname,
                          lambda: previous.module.backward_rows(
                              prep, pairs, s, **inputs)))
    log(view="train step view 2", k2_wrapper_checkpoints_ms=cs.time_ms(
        lambda: CR.backward_rows(prep, pairs, s, **inputs,
                                 checkpoints=ckpts[CR.SEGMENT]), 20))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--previous", type=Path, default=None)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    log(card=smi.stdout.strip())
    k1 = build("rasterize_fwd", K1_VARIANTS)
    k2 = build("rasterize_bwd", K2_VARIANTS)
    previous = cs.PreviousKernels(args.previous) if args.previous else None
    params = cs.convert.params_from_numpy(scenes.lego_params(), dev)
    k1_variants(k1, previous, params, dev)
    k2_variants(k2, previous, dev)
    if args.out:
        args.out.write_text("\n".join(json.dumps(r) for r in RECORDS) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
