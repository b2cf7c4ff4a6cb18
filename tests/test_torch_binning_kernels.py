"""The binning entry ``ops/cuda_binning.py::build_pairs`` on the CPU.

For CPU tensors the entry runs the plain version, ``ops/binning.py::
build_pairs``, with every argument it takes (the cull, a kept capacity, a
band), and counts no launch; on the gate with the cull off its ``Pairs``
are the stored JAX pairs.  It launches nothing for a device without
kernels.  The kernels themselves run in ``tests/test_torch_cuda.py`` on a
card, against the plain version and the stored JAX pairs.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gstpu_torch import convert
from gstpu_torch.ops import binning, cuda_binning, rasterize
from gstpu_torch.scenes import GATE_NPZ
from gstpu_torch.utils import tracing


def _gate(case):
    """The gate's prep as ``_render_fwd`` bins it (the whole grid, or the
    band of rows 1, 3, ..., 9), the pair cull on unless ``case`` is
    "cull_off"."""
    g = np.load(GATE_NPZ)
    prep = convert.prep_from_numpy(g, "cpu")
    row0, stride, rows = (1, 2, 5) if case == "band" else (0, 1, 10)
    rect, tiles = rasterize.clip_rect_to_band(prep.rect, prep.tiles_touched,
                                              row0, rows, stride)
    kw = dict(row0=row0, row_stride=stride)
    if case != "cull_off":
        kw.update(cull_xy=prep.xy,
                  cull_tcut=rasterize.pair_cull_threshold(prep))
    return (tiles, rect, prep.depth, 10, 10 * rows, 1 << 16), kw


def _case(case):
    args, kw = _gate(case)
    if case == "kept_capacity":
        kept = int(binning.build_pairs(*args, **kw).num_kept)
        kw["kept_capacity"] = -(-int(kept * 1.05) // 1024) * 1024
    return args, kw


@pytest.mark.parametrize("case", ["cull_off", "kept_capacity", "band"])
def test_entry_runs_the_plain_version_on_the_cpu(case):
    args, kw = _case(case)
    before = dict(tracing.COUNTERS)
    got = cuda_binning.build_pairs(*args, **kw)
    assert tracing.COUNTERS == before
    assert chip_smoke.pairs_equal(got, binning.build_pairs(*args, **kw)) == []
    if case == "cull_off":
        stored = convert.pairs_from_numpy(np.load(GATE_NPZ), "cpu")
        assert chip_smoke.pairs_equal(got, stored) == []


def test_entry_launches_nothing_without_kernels_for_the_device():
    args, kw = _gate("cull_on")

    def meta(x):
        return x.to("meta") if torch.is_tensor(x) else x

    before = dict(tracing.COUNTERS)
    with pytest.raises(ValueError, match="no binning kernel"):
        cuda_binning.build_pairs(*map(meta, args),
                                 **{k: meta(v) for k, v in kw.items()})
    # the kernels' path takes no CPU tensor: it raises, never falls back
    with pytest.raises(ValueError, match="no binning kernel"):
        cuda_binning._build_pairs_cuda(*args, **kw)
    assert tracing.COUNTERS == before
