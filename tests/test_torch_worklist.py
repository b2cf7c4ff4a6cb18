"""The work order of kernels K1 and K2 (``gstpu_torch/ops/cuda_rasterize.py``).

- ``build_work_list``: every tile by ``tile_count``, descending and stable,
  int32 (K1's CTAs and K2's whole-tile items); for segments, the inclusive
  prefix sum of the tiles' segment counts in that order, from which each
  tile owns its checkpoint slots (their first slot per tile is the exclusive
  prefix sum), and room for the fixed bound T + K2 // segment of items.
- ``work_items``: the plain version of the items K1 writes: every
  (tile, segment) exactly once, the segments of a tile covering
  [0, tile_count) without gaps or overlaps, deepest tile first and a tile's
  segments in order, pads (-1, 0) past the last item.  Counts 0, 1, S - 1,
  S, S + 1, 2S, 2S + 1 and 4,504 (the deepest tile of the 800x800 Lego
  orbit view) over the tiles of a row band.
- ``_check_checkpoints``: the wrapper's check of a work list and
  checkpoint buffer raises ValueError on each malformed field.

These are the wrapper's PyTorch ops; they run the same on the CPU as on
the card.
"""

import numpy as np
import pytest
import torch

from gstpu_torch.config import RenderSettings, TILE_PIXELS
from gstpu_torch.ops import cuda_rasterize as CR

# a band of tile rows 1, 3, 5 of a 160x112 image (row0 1, row stride 2)
BAND = RenderSettings(width=160, height=112, tile_rows=3, row_stride=2)


def _band_counts(seed, segment):
    """Counts over the band's 30 tiles: the edge cases around ``segment``,
    0, 1 and 4,504, then random counts (ties included); and the pair slots
    (the count sum plus slack)."""
    rng = np.random.default_rng(seed)
    t = BAND.band_tiles
    edges = [0, 0, 1, 4504, segment - 1, segment, segment + 1, 2 * segment,
             2 * segment + 1, segment]
    counts = np.concatenate([edges, rng.integers(0, 3 * segment,
                                                 t - len(edges))])
    rng.shuffle(counts)
    return torch.tensor(counts, dtype=torch.int32), int(counts.sum()) + 37


def _filled(counts, slots, segment):
    work = CR.build_work_list(counts, slots, segment)
    return work._replace(items=CR.work_items(work, counts))


@pytest.mark.parametrize("segment", [256, 512, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_work_items_cover_every_segment_once(segment, seed):
    counts, slots = _band_counts(seed, segment)
    t = counts.shape[0]
    work = _filled(counts, slots, segment)
    m = t + slots // segment
    assert work.segment == segment
    assert work.items.dtype == torch.int32 and work.items.shape == (m, 2)
    assert work.ends.dtype == torch.int32 and work.ends.shape == (t,)

    nseg = [-(-int(c) // segment) for c in counts]
    n = int(work.ends[-1])
    assert n == sum(nseg) <= m
    assert work.items[n:].tolist() == [[-1, 0]] * (m - n)

    parts = {}
    for tile, k in work.items[:n].tolist():
        first = k * segment
        parts.setdefault(tile, []).append(
            (first, min(segment, int(counts[tile]) - first)))
    assert sorted(parts) == [i for i in range(t) if counts[i] > 0]
    for tile, segs in parts.items():
        assert len(segs) == nseg[tile]
        pos = 0
        for first, length in segs:                # in order, no gap or overlap
            assert first == pos and 0 < length <= segment
            pos += length
        assert pos == int(counts[tile])


@pytest.mark.parametrize("segment", [256, 512])
def test_work_items_are_deepest_first_and_stable(segment):
    counts, slots = _band_counts(2, segment)
    work = _filled(counts, slots, segment)
    n = int(work.ends[-1])
    keys = [(-int(counts[tile]), tile, k)
            for tile, k in work.items[:n].tolist()]
    # by tile_count descending; equal counts in tile order; then segments
    assert keys == sorted(keys)
    assert work.items[0].tolist() == [int(torch.argmax(counts)), 0]


@pytest.mark.parametrize("segment", [256, 512])
def test_checkpoint_slots_are_the_exclusive_prefix_sum(segment):
    """Slot b holds item b; the first slot of the tile of rank r is the
    exclusive prefix sum of the segment counts of the ranks before it."""
    counts, slots = _band_counts(3, segment)
    work = _filled(counts, slots, segment)
    order = work.order.tolist()
    nseg = [-(-int(counts[i]) // segment) for i in order]
    firsts = np.concatenate([[0], np.cumsum(nseg)[:-1]])
    np.testing.assert_array_equal(work.ends.numpy(), np.cumsum(nseg))
    for rank, tile in enumerate(order):
        for k in range(nseg[rank]):
            assert work.items[firsts[rank] + k].tolist() == [tile, k]


def test_tile_order_is_every_tile_deepest_first():
    counts, _ = _band_counts(4, 512)
    work = CR.build_work_list(counts, int(counts.sum()))
    assert work.segment == CR.WHOLE_TILE
    assert work.ends is None and work.items is None
    order = work.order
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(counts.shape[0]))
    keys = [(-int(counts[i]), i) for i in order.tolist()]
    assert keys == sorted(keys)


@pytest.mark.parametrize("segment,items,tail", [(256, 18, 152),
                                                (512, 9, 408)])
def test_work_list_of_the_deepest_orbit_tile(segment, items, tail):
    """4,504 pairs in one tile of an otherwise empty 800x800 grid at the
    training step's pair capacity: ``items`` items of at most ``segment``
    pairs, the ``tail``-pair one last, in a list of 2,500 + 4,653,056 //
    segment slots."""
    counts = torch.zeros(2500, dtype=torch.int32)
    counts[1234] = 4504
    work = _filled(counts, 4_653_056, segment)
    assert work.items.shape == (2500 + 4_653_056 // segment, 2)
    assert int(work.ends[-1]) == items
    assert work.items[:items].tolist() == [[1234, k] for k in range(items)]
    assert 4504 - (items - 1) * segment == tail


def test_check_checkpoints_rejects_malformed_lists():
    counts, slots = _band_counts(0, 512)
    t = counts.shape[0]
    dev = torch.device("cpu")
    work = _filled(counts, slots, 512)
    state = torch.zeros((work.items.shape[0], len(CR.CHECKPOINT_FIELDS),
                         TILE_PIXELS))
    CR._check_checkpoints(CR.Checkpoints(work, state), t, slots, dev)
    bad = [
        (work._replace(items=work.items.long()), state),
        (work._replace(items=work.items[:-1]), state),
        (work._replace(items=work.items.t().contiguous().t()), state),
        (work._replace(items=None), state),
        (work._replace(ends=work.ends[1:]), state),
        (work._replace(ends=work.ends.long()), state),
        (work._replace(ends=None), state),
        (work._replace(order=work.order[:-1]), state),
        (work._replace(order=work.order.long()), state),
        (work._replace(segment=500), state),              # not a batch multiple
        (work._replace(segment=0), state),
        (CR.build_work_list(counts, slots), state),       # whole tiles
        (work, state[:, :5]),
        (work, state.double()),
        (work, state[:-1]),
        (work, None),
    ]
    for w, s in bad:
        with pytest.raises(ValueError):
            CR._check_checkpoints(CR.Checkpoints(w, s), t, slots, dev)
    with pytest.raises(ValueError, match="on cuda"):
        CR._check_checkpoints(CR.Checkpoints(work, state), t, slots,
                              torch.device("cuda"))
