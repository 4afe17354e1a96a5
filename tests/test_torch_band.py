"""The punch's band maximum (``kernels/band.py``) on the CPU.

``band_plan`` is held to what ``band_max_kernel`` (``csrc/band.cu``) needs
of it: the levels and the clamped block starts, every offset's halo inside
its CTA's pairs, the pairs inside shared memory, and the wide path where
the halo does not fit.  CPU tensors take the plain version only.  The
kernels themselves are held bit for bit to ``band_max_reference`` on the
card by ``chip_smoke.py``'s ``band`` phase.
"""

import math

import numpy as np
import pytest
import torch

from strugatzki_tpu_torch.kernels import band as BM

TP, L_IN, L_OUT = 1536, 200, 120
W_IN, W_OUT = TP - L_IN + 1, TP - L_OUT + 1        # 1337: no tile divides it
#: files: full, a tombstone, shorter than the punch-in, shorter than the
#: punch-out band, ragged
LENS = [TP, 0, L_IN - 5, 700, TP - 301, 1000]
#: the band widths S: one, two, around a power of two, the benchmark's
#: (690), and one wider than a default tile and than ``w_pad``
SPANS = [1, 2, 511, 512, 513, 690, 5000]
#: (W_in, Tp): a row of one tile, and the benchmark's punch step (9,892
#: offsets, several tiles)
WIDTHS = [(W_IN, TP), (9892, 10752)]


def _traces(seed: int):
    """Traces of few distinct values (ties everywhere) with NaN, ±inf and
    ±0 among them."""
    rng = np.random.default_rng(seed)
    pool = np.float32([-0.5, -0.0, 0.0, 0.25, 0.5, 0.75, 1.0, np.inf,
                       -np.inf, np.nan])
    prob = np.array([1, 1, 1, 2, 3, 3, 2, 0.3, 0.3, 0.6])
    s_in = rng.choice(pool, (len(LENS), W_IN), p=prob / prob.sum())
    s_out = rng.choice(pool, (len(LENS), W_OUT), p=prob / prob.sum())
    s_out[:, :40] = np.nan                  # a constant group's windows
    return s_in.astype(np.float32), s_out.astype(np.float32)


@pytest.mark.parametrize("min_punch_past", [0, 37, None])
@pytest.mark.parametrize("S", SPANS)
@pytest.mark.parametrize("W_in,Tp", WIDTHS)
def test_plan_covers_every_offsets_band(W_in, Tp, S, min_punch_past):
    # None: min_punch past Tp, so both block starts clamp
    min_punch = Tp + 50 if min_punch_past is None else min_punch_past
    plan = BM.band_plan(W_in, Tp, min_punch, S)
    p = 1 << plan.j_sel
    # the two power blocks cover the band [min_punch, min_punch + S)
    assert p <= S < 2 * p or p * 2 > W_in + Tp
    assert plan.s1 == min(min_punch, Tp)
    assert plan.s2 == min(max(min_punch + S - p, 0), Tp)
    assert not plan.wide
    lo, hi = min(plan.s1, plan.s2), max(plan.s1, plan.s2)
    # every CTA holds a tile of offsets, none is empty, the last may be short
    assert plan.tiles * plan.tile >= W_in > (plan.tiles - 1) * plan.tile
    assert BM.BAND_MIN_TILE <= plan.tile <= BM.BAND_TILE or \
        plan.tiles == 1
    assert plan.pairs % 4 == 0 and plan.pairs <= BM.BAND_PAIRS
    for k in range(plan.tiles):
        t0 = k * plan.tile
        n = min(plan.tile, W_in - t0)
        n0 = n + (hi - lo) + p - 1          # the halo band.cu loads
        for m in range(4):                  # pairs before it, for alignment
            assert m + n0 <= plan.pairs
            # after j_sel levels the first m + n0 − (p − 1) pairs hold a
            # whole level; both blocks of the tile's last offset read there
            last = m + (n - 1) + (hi - lo)
            assert last < m + n0 - (p - 1)
        # and every position they cover lies inside the padded row
        assert t0 + n - 1 + hi + p - 1 < W_in + Tp + p - 1


@pytest.mark.parametrize("S,min_punch,want", [
    (1, 0, (0, 0, 0)), (2, 0, (1, 0, 0)), (690, 1034, (9, 1034, 1212)),
    (512, 0, (9, 0, 0)), (513, TP + 50, (9, TP, TP)),
    (5000, 37, (12, 37, 941))])
def test_plan_levels_and_clamped_block_starts(S, min_punch, want):
    plan = BM.band_plan(W_IN, TP, min_punch, S)
    assert (plan.j_sel, plan.s1, plan.s2) == want


def test_plan_at_the_benchmark_step_and_the_wide_path():
    # a punch files step over two-minute files: T 10,752, 10 s in, 5 s out
    plan = BM.band_plan(9892, 10752, 1034, 690)
    assert (plan.j_sel, plan.tiles, plan.tile, plan.wide) == (9, 3, 3298,
                                                              False)
    assert plan.pairs == 3992                 # 31.9 KB of shared memory
    # the tile halves as the band grows, down to BAND_MIN_TILE
    wide = BM.band_plan(9892, 10752, 1034, 26000)
    assert (wide.tiles, wide.tile) == (5, 1979) and wide.pairs <= BM.BAND_PAIRS
    # at T 10,752 the clamped second block still keeps 30,000 frames in
    assert not BM.band_plan(9892, 10752, 1034, 30000).wide
    # a band over ~28,700 frames does not fit beside the smallest tile: the
    # levels run through a global scratch
    plan = BM.band_plan(79140, 80000, 1034, 30000)
    assert plan == (14, 1034, 14650, 0, 0, 0, True)
    assert BM.BAND_MIN_TILE + (14650 - 1034) + (1 << 14) - 1 + 3 > \
        BM.BAND_PAIRS


def test_cpu_tensors_take_the_reference_and_never_the_kernel():
    s_in, s_out = _traces(1)
    k0, r0 = BM.KERNEL_LAUNCHES, BM.REFERENCE_CALLS
    args = (torch.from_numpy(s_in), torch.from_numpy(s_out),
            torch.tensor(LENS, dtype=torch.int32), L_IN, L_OUT, TP)
    BM.band_max(*args, 37, 690)
    BM.band_max(*args, 0, 30000)            # a wide band all the same
    assert (BM.KERNEL_LAUNCHES, BM.REFERENCE_CALLS) == (k0, r0 + 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        BM.band_max_cuda(*args, 37, 690)
    assert BM.KERNEL_LAUNCHES == k0


def test_query_punch_on_the_cpu_reaches_only_the_reference():
    from strugatzki_tpu_torch import FeatureDatabase
    from strugatzki_tpu_torch.analysis.correlation import InputTemplate

    rng = np.random.default_rng(4)
    entries = [(f"f{i}.aif", rng.random((14, 900), dtype=np.float32))
               for i in range(3)]
    norm = np.stack([np.zeros(14), np.ones(14)], 1).astype(np.float32)
    db = FeatureDatabase(entries, norm, device="cpu")
    query = rng.random((14, 900), dtype=np.float32)
    t_in = InputTemplate.from_features(query, norm, 100, 180)
    t_out = InputTemplate.from_features(query, norm, 300, 340)
    k0, r0 = BM.KERNEL_LAUNCHES, BM.REFERENCE_CALLS
    res = db.query_punch(t_in, t_out, 100, 300, k=2)
    assert BM.KERNEL_LAUNCHES == k0 and BM.REFERENCE_CALLS > r0
    assert res.sims.shape == (3, 2) and math.isfinite(res.sims[0, 0])
