#!/usr/bin/env python3
"""Ablations of the compositing kernels K1, K2 and K3 on a CUDA card.

    python3 scripts/torch_kernel_variants.py [--kernels K1 K2 K3]
        [--previous DIR] [--out PATH]

Builds variants of ``gstpu_torch/csrc/rasterize_fwd.cu`` (K1),
``rasterize_bwd.cu`` (K2) and ``sol_compositing.cu`` (K3) that differ from
the sources in one design constant each (the line is replaced; a line not
found raises), with the flags of ``ops/cuda_build.py``.  A variant keeps
the source's C interface, so the wrappers of ``ops/cuda_rasterize.py`` and
``sol_model.py`` launch it in place of the source (``launching``), and
``chip_smoke.bare_ms`` times the bare launch (20 back to back per
CUDA-event pair, median of 5) on the shapes of ``chip_smoke.py``:

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
- K3 at the speed-of-light model's volumes (2,500 tiles, 2 chunks), forward
  and backward: every other value of each design constant of the source
  (``K3_CONSTANTS``: pixels per thread, lanes per backward butterfly, lane
  records hoisted or not, t_ex by division or from the exclusive product, a
  CTA per tile or a persistent grid).  Each variant is held against the
  plain version (``chip_smoke.K3_FWD_TOL``, ``K3_BWD_REL_TOL``), and its
  bits are compared with the source's.  ``cuobjdump -sass`` of each
  variant's library (and of the source's and the parent's) gives the
  instructions per (pixel, lane) step of each form: the instructions of the
  innermost loop that holds a ``MUFU.EX2`` (one per step), over the number
  of those (``sass_per_step``).

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
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gstpu_torch import scenes, sol_model  # noqa: E402
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
# K3's design constants and the values tried: {name: (C++ type, values)}
K3_CONSTANTS = {"kFwdPixPerThread": ("int", (1, 2, 4, 8)),
                "kBwdPixPerThread": ("int", (1, 2, 4)),
                "kLaneBatch": ("int", (1, 2, 4, 8, 16)),
                "kHoistLanes": ("bool", ("true", "false")),
                "kExclusiveT": ("bool", ("true", "false")),
                "kPersistent": ("bool", ("true", "false"))}
RECORDS = []
PATHS = {}       # (kernel, variant): the variant's library
# each kernel's source library, whose launch function a variant replaces
SOURCE_LIBRARY = {"rasterize_fwd": lambda: CR._library("rasterize_fwd"),
                  "rasterize_bwd": lambda: CR._library("rasterize_bwd"),
                  "sol_compositing": sol_model._library}


def log(**kw) -> None:
    RECORDS.append(kw)
    print(json.dumps(kw), flush=True)


@contextlib.contextmanager
def launching(kernel: str, fn):
    """Within the block the wrappers launch ``fn`` (a variant's launch
    function, the source's C interface) in place of the source's."""
    lib = SOURCE_LIBRARY[kernel]()
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


def one_constant_variants(kernel: str, constants: dict) -> dict:
    """{variant: {line: new line}}: the source, then each other value of
    each of ``constants`` (``constexpr <type> <name> = <value>;`` in the
    source) with the rest as the source has them."""
    src = (cuda_build.CSRC / f"{kernel}.cu").read_text()
    variants = {"source": {}}
    for name, (ctype, values) in constants.items():
        m = re.search(rf"constexpr {ctype} {name} = (\w+);", src)
        if m is None:
            raise RuntimeError(f"{kernel}: no constant {name} to vary")
        for value in values:
            if str(value) != m.group(1):
                line = f"constexpr {ctype} {name} = {value};"
                variants[line] = {m.group(0): line}
    return variants


def build(kernel: str, variants: dict) -> dict:
    """{variant: launch function of the loaded library}, every variant built
    at once; the libraries' paths go to ``PATHS``."""
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
            raise RuntimeError(f"{kernel} variant {name!r} did not build:"
                               f"\n{out}")
        lib = ctypes.CDLL(str(path.with_suffix(".so")))
        fn = getattr(lib, f"gstpu_{kernel}")
        fn.argtypes = getattr(SOURCE_LIBRARY[kernel](),
                              f"gstpu_{kernel}").argtypes
        libs[name] = fn
        PATHS[(kernel, name)] = path.with_suffix(".so")
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
    if previous is not None:    # from the parent K1's own checkpoints
        mod = previous.module
        p_ckpt = mod.composite_forward_checkpointed(prep, pairs, s)[4]
        log(kernel="K2", view="train step view 2", variant="parent",
            ms=cs.bare_ms(previous.libs["rasterize_bwd"], fname,
                          lambda: mod.backward_rows(prep, pairs, s, **inputs,
                                                    checkpoints=p_ckpt)))
    log(view="train step view 2", k2_wrapper_checkpoints_ms=cs.time_ms(
        lambda: CR.backward_rows(prep, pairs, s, **inputs,
                                 checkpoints=ckpts[CR.SEGMENT]), 20))


def sass(path: Path) -> dict:
    """{function: [(address, instruction)]} of a library, by
    ``cuobjdump -sass``; a branch's target is its address (``BRA 0x1c0``)
    or a label (``BRA `(.L_x_3)``) that is resolved to one."""
    tool = Path(cuda_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    funcs, labels, cur, pending = {}, {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            addr = int(m.group(1), 16)
            labels.update({name: addr for name in pending})
            pending = []
            cur.append((addr, m.group(2).strip()))
    for name, instrs in funcs.items():
        funcs[name] = [(a, re.sub(r"`\((\.L_x_\d+)\)",
                                  lambda m: hex(labels[m.group(1)]), ins))
                       for a, ins in instrs]
    return funcs


def _opcode(ins: str) -> str:
    tokens = ins.split()
    return tokens[1] if tokens[0].startswith("@") else tokens[0]


SASS_CLASSES = {"fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP",
                         "FCHK", "FSET"),
                "mufu": ("MUFU",), "shfl": ("SHFL",), "lds": ("LDS",),
                "sts": ("STS",), "branch": ("BRA", "BSSY", "BSYNC", "CALL")}


def loop_per_step(instrs) -> dict | None:
    """The innermost loop (a backward branch and its target) that holds a
    ``MUFU.EX2``: its instructions (NOPs left out) by class, its exps, and
    instructions per exp, which is per (pixel, lane) step in K3.  Code in
    that address range runs once a step unless it is a slow path (the
    division's) that a step only reaches on special operands."""
    best = None
    for addr, ins in instrs:
        m = re.match(r"BRA(?:\.\S+)? (0x[0-9a-f]+)", ins.split(" ", 1)[-1]
                     if ins.startswith("@") else ins)
        if not m or int(m.group(1), 16) > addr:
            continue
        lo = int(m.group(1), 16)
        body = [_opcode(i) for a, i in instrs
                if lo <= a <= addr and _opcode(i) != "NOP"]
        exps = body.count("MUFU.EX2")
        if exps and (best is None or len(body) < best["instructions"]):
            by_class = {k: sum(op.split(".")[0] in v for op in body)
                        for k, v in SASS_CLASSES.items()}
            by_class["other"] = len(body) - sum(by_class.values())
            best = {"instructions": len(body), "exps": exps,
                    "per_step": len(body) / exps, "by_class": by_class}
    return best


def sass_per_step(path: Path) -> dict:
    """{form: loop_per_step} of K3's two kernels in the library at path."""
    out = {}
    for name, instrs in sass(path).items():
        if "sol_compositing_kernel" in name:
            out["bwd" if "ILb1E" in name else "fwd"] = loop_per_step(instrs)
    return out


def k3_errors(got, want, backward: bool) -> float:
    """The check of ``chip_smoke`` phase 9: the largest absolute difference
    (forward) or the largest over each row's largest magnitude (backward)."""
    diff = (got.double() - want.double()).abs()
    if not backward:
        return float(diff.max())
    scale = want.double().abs().amax(dim=(0, 2)).clamp(min=1e-12)
    return float((diff.amax(dim=(0, 2)) / scale).max())


def k3_variants(libs, previous, dev) -> None:
    feat = sol_model.feature_block(dev)
    fname = "gstpu_sol_compositing"
    forms = {False: "fwd", True: "bwd"}

    def args(backward):
        return feat, sol_model.N_CHUNKS, sol_model.TILES, backward

    plain = {b: sol_model.sol_compositing_plain(*args(b)) for b in forms}
    ref = {}
    for name, fn in libs.items():
        res = {}
        with launching("sol_compositing", fn) as lib:
            for backward, form in forms.items():
                got = sol_model.sol_compositing(*args(backward)).clone()
                ref.setdefault(backward, got)
                err = k3_errors(got, plain[backward], backward)
                res[f"{form}_ms"] = cs.bare_ms(
                    lib, fname,
                    lambda b=backward: sol_model.sol_compositing(*args(b)))
                res[f"{form}_err"] = err
                res[f"{form}_bit_identical_to_source"] = cs.bits_equal(
                    [got], [ref[backward]])
                res[f"{form}_ok"] = bool(
                    torch.isfinite(got).all()
                    and err < (cs.K3_BWD_REL_TOL if backward
                               else cs.K3_FWD_TOL))
        res["sass"] = sass_per_step(PATHS[("sol_compositing", name)])
        log(kernel="K3", variant=name, tiles=sol_model.TILES,
            n_chunks=sol_model.N_CHUNKS, **res)
        if not (res["fwd_ok"] and res["bwd_ok"]):
            raise RuntimeError(f"K3 variant {name!r} is wrong: {res}")
    log(kernel="K3", variant="source library",
        library=str(cuda_build.build()["sol_compositing"][0]),
        sass=sass_per_step(cuda_build.build()["sol_compositing"][0]))
    if previous is not None:
        plib = previous.libs["sol_compositing"]
        p_fn = previous.sol.sol_compositing
        log(kernel="K3", variant="parent", **{
            f"{form}_ms": cs.bare_ms(plib, fname,
                                     lambda b=b: p_fn(*args(b)))
            for b, form in forms.items()},
            sass=sass_per_step(previous.paths["sol_compositing"]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels", nargs="+", default=["K1", "K2", "K3"],
                        choices=["K1", "K2", "K3"])
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
    built = {}
    for kernel, (name, variants) in {
            "K1": ("rasterize_fwd", K1_VARIANTS),
            "K2": ("rasterize_bwd", K2_VARIANTS),
            "K3": ("sol_compositing", one_constant_variants(
                "sol_compositing", K3_CONSTANTS))}.items():
        if kernel in args.kernels:
            built[kernel] = build(name, variants)
    previous = cs.PreviousKernels(args.previous) if args.previous else None
    if "K1" in built:
        params = cs.convert.params_from_numpy(scenes.lego_params(), dev)
        k1_variants(built["K1"], previous, params, dev)
    if "K2" in built:
        k2_variants(built["K2"], previous, dev)
    if "K3" in built:
        k3_variants(built["K3"], previous, dev)
    if args.out:
        args.out.write_text("\n".join(json.dumps(r) for r in RECORDS) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
