"""The port's database preparation on the CPU against the JAX package's
Pallas kernel (interpret mode) and its XLA formulation, and the work plan
of the long-file kernel ``prep_long``.

On the CPU the port runs ``prepare_database_reference``, the plain
PyTorch version that ``chip_smoke.py`` holds the CUDA kernel to on the card.
Tolerances: values and shifts atol 1e-6 (f32 sums over at most 1,200
elements in another order); NaN and inf positions equal; frames at or past
a file's length exactly ``-shift``.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strugatzki_tpu.kernels.pallas_prep import (prepare_database as jax_prep,
                                                prepare_database_xla)
from strugatzki_tpu_torch.kernels import prep as P
from test_pallas_prep import _batch


def _cases():
    """The cases of tests/test_pallas_prep.py, plus a zero-length file and a
    degenerate (min == max) norm row."""
    cases = {}
    for seed in (0, 3, 5):
        feats, lens, norm = _batch(seed=seed)
        cases[f"seed{seed}"] = (feats, lens, norm)
    feats, lens, norm = _batch(seed=8)
    lens = lens.copy()
    lens[2] = 0
    feats[2] = 0.0
    cases["zero_length"] = (feats, lens, norm)
    feats, lens, norm = _batch(seed=9)
    norm = norm.copy()
    norm[3, 1] = norm[3, 0]       # spectral row: its group shift goes NaN/inf
    cases["degenerate_row"] = (feats, lens, norm)
    feats, lens, norm = _batch(seed=10)
    norm = norm.copy()
    norm[0, 1] = norm[0, 0]       # the temporal row itself
    cases["degenerate_temporal"] = (feats, lens, norm)
    return cases


CASES = _cases()


def _assert_same(out, sh, ref_out, ref_sh):
    out, sh = np.asarray(out), np.asarray(sh)
    ref_out, ref_sh = np.asarray(ref_out), np.asarray(ref_sh)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref_out))
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref_out))
    np.testing.assert_allclose(out, ref_out, atol=1e-6)     # NaN == NaN here
    np.testing.assert_array_equal(np.isnan(sh), np.isnan(ref_sh))
    np.testing.assert_allclose(sh, ref_sh, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_pallas_interpret_and_xla(name):
    feats, lens, norm = CASES[name]
    out, sh = P.prepare_database(feats, norm, lens, device="cpu")
    assert out.dtype == torch.float32 and out.shape == feats.shape
    assert sh.shape == (feats.shape[0],)

    ref_p, sh_p = jax_prep(feats, norm, lens, interpret=True)
    _assert_same(out, sh, ref_p, sh_p)
    ref_x, sh_x = prepare_database_xla(jnp.asarray(feats), jnp.asarray(norm),
                                       jnp.asarray(lens))
    _assert_same(out, sh, ref_x, sh_x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tail_is_exactly_minus_shift(name):
    feats, lens, norm = CASES[name]
    out, sh_t = P.prepare_database(feats, norm, lens, device="cpu")
    out = out.numpy()
    for b, n in enumerate(lens):
        tail = out[b, :, n:]
        if tail.shape[1] == 0:
            continue
        np.testing.assert_array_equal(tail[:1], np.full_like(tail[:1],
                                                             -sh_t[b].item()))
        # all spectral rows share one shift
        np.testing.assert_array_equal(tail[1:], np.broadcast_to(
            tail[1:2, :1], tail[1:].shape))


def test_none_norm_is_identity():
    feats, lens, _ = _batch(seed=5)
    a, sa = P.prepare_database(feats, None, lens, device="cpu")
    ident = np.stack([np.zeros(6), np.ones(6)], axis=1).astype(np.float32)
    b, sb = P.prepare_database(feats, ident, lens, device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(sa.numpy(), sb.numpy())


def test_num_temporal_two_matches_xla():
    feats, lens, norm = _batch(seed=12)
    out, sh = P.prepare_database(feats, norm, lens, num_temporal=2,
                                 device="cpu")
    ref, ref_sh = prepare_database_xla(jnp.asarray(feats), jnp.asarray(norm),
                                       jnp.asarray(lens), num_temporal=2)
    _assert_same(out, sh, ref, ref_sh)


def test_cpu_tensors_take_the_reference_and_never_the_kernel():
    feats, lens, norm = _batch(seed=0)
    k0, r0 = P.KERNEL_LAUNCHES, P.REFERENCE_CALLS
    P.prepare_database(feats, norm, lens, device="cpu")
    assert (P.KERNEL_LAUNCHES, P.REFERENCE_CALLS) == (k0, r0 + 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.prepare_database_cuda(torch.from_numpy(feats),
                                torch.from_numpy(norm),
                                torch.from_numpy(lens))
    assert P.KERNEL_LAUNCHES == k0


def test_variant_counters_stay_apart_from_the_reference():
    feats, lens, norm = _batch(seed=1)
    k0, r0 = P.KERNEL_LAUNCHES, P.REFERENCE_CALLS
    P.prepare_database(feats, norm, lens, device="cpu")
    assert (P.KERNEL_LAUNCHES, P.REFERENCE_CALLS) == (k0, r0 + 1)


# ---------------------------------------------------------------------------
# the padded tail: nothing in it reaches the result
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fill", ["nan", "inf", "-inf", "mixed"])
def test_nan_and_inf_in_the_padded_tail_change_nothing(fill):
    """``prep_long`` never reads a frame at or past a file's length: the
    semantics it relies on.  NaN or inf written there leave the plain
    version equal to the XLA formulation and the Pallas kernel (interpret
    mode), and the tail exactly ``-shift``."""
    feats, lens, norm = _batch(seed=21)
    clean, clean_sh = P.prepare_database(feats, norm, lens, device="cpu")
    dirty = feats.copy()
    rng = np.random.default_rng(21)
    for b, n in enumerate(lens):
        tail = dirty[b, :, n:]
        if fill == "mixed":
            tail[...] = rng.choice(np.float32([np.nan, np.inf, -np.inf, 1e30]),
                                   tail.shape)
        else:
            tail[...] = np.float32(fill)
    out, sh = P.prepare_database(dirty, norm, lens, device="cpu")
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_array_equal(out.numpy(), clean.numpy())
    np.testing.assert_array_equal(sh.numpy(), clean_sh.numpy())
    ref_p, sh_p = jax_prep(dirty, norm, lens, interpret=True)
    _assert_same(out, sh, ref_p, sh_p)
    ref_x, sh_x = prepare_database_xla(jnp.asarray(dirty), jnp.asarray(norm),
                                       jnp.asarray(lens))
    _assert_same(out, sh, ref_x, sh_x)
    out = out.numpy()
    for b, n in enumerate(lens):
        if n < feats.shape[2]:
            np.testing.assert_array_equal(
                out[b, :1, n:], np.full_like(out[b, :1, n:], -sh[b].item()))
            np.testing.assert_array_equal(
                out[b, 1:, n:], np.broadcast_to(out[b, 1:2, n:n + 1],
                                                out[b, 1:, n:].shape))


# ---------------------------------------------------------------------------
# prep_long's work plan: coverage, order and progress of the queue
# ---------------------------------------------------------------------------

#: resident CTAs of 48 KiB tiles on an H100 SXM: four a SM on 132 SMs
H100_CTAS = 4 * 132


def _queue(plan, C, T, lens):
    nv = -(-np.clip(np.asarray(lens, np.int64), 0, T) // plan.tile)
    return (nv, *P.long_queue(plan, C, T, lens))


def _check_queue(plan, C, T, lens):
    """Every tile written exactly once, every tile of valid frames reduced
    exactly once, each file's reduce tiles dispensed before any tile that
    only writes, and reduce tickets within the partials' scratch."""
    B, NT = len(lens), plan.tiles_per_row
    nv, kind, f, row, k = _queue(plan, C, T, lens)
    assert ((0 <= row) & (row < C) & (0 <= k) & (k < NT)).all()
    tile_id = (f * C + row) * NT + k
    reduce = (kind == P.HOLD) | (kind == P.REDUCE)
    write = kind != P.REDUCE
    valid = k < nv[f]
    assert (valid == (kind != P.TAIL)).all()
    assert np.array_equal(np.bincount(tile_id[write], minlength=B * C * NT),
                          np.ones(B * C * NT, np.int64))
    reduced = np.bincount(tile_id[reduce], minlength=B * C * NT)
    assert np.array_equal(reduced.reshape(B, C, NT),
                          (np.arange(NT) < nv[:, None, None]).repeat(C, 1)
                          .astype(np.int64))
    tickets = np.arange(len(kind))
    last_reduce = np.full(B, -1)
    np.maximum.at(last_reduce, f[reduce], tickets[reduce])
    first_write = np.full(B, len(kind))
    only = write & ~reduce
    np.minimum.at(first_write, f[only], tickets[only])
    assert (last_reduce < first_write).all()
    assert tickets[reduce].max(initial=-1) < B * C * NT   # partial[t]


def _simulate(plan, C, T, lens):
    """``plan.grid`` resident CTAs take tickets in order.  A CTA that has
    to wait for its file's shifts stays held until no CTA is free, and only
    then are the held CTAs of published files released (the slowest
    schedule the card could run).  Returns 1 if the queue stalls (no CTA
    free and none can be released), else 0."""
    nv, kind, f, _, _ = _queue(plan, C, T, lens)
    need = (C * nv).tolist()
    arrived = [0] * len(lens)
    held = Counter()
    free = plan.grid
    kind, f = kind.tolist(), f.tolist()
    i = 0
    while i < len(kind):
        if free == 0:
            done = [b for b in held if arrived[b] == need[b]]
            if not done:
                return 1
            for b in done:
                free += held.pop(b)
            continue
        b = f[i]
        if kind[i] in (P.HOLD, P.REDUCE):
            arrived[b] += 1          # a CTA never waits before it arrives
        if kind[i] != P.REDUCE and arrived[b] < need[b]:
            held[b] += 1
            free -= 1
        i += 1
    assert arrived == need
    return 0


def _lens(seed, B, T):
    """Lengths of 2-6 minutes (clipped to T), one file at T, and the edge
    lengths 0, 1, T - 1 and one past T."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(10335, 31008, B).clip(0, T)
    edges = [T, 0, 1, T - 1, T + 5]
    lens[:len(edges)] = edges[:B]
    return [int(n) for n in lens]


@pytest.mark.parametrize("B,C,T,ctas,tile,resident", [
    (65535, 14, 33061, H100_CTAS, P.LONG_TILE, True),    # the shortest T
    (2048, 14, 36352, H100_CTAS, P.LONG_TILE, True),     # the song slab
    (65, 14, 40448, H100_CTAS, P.LONG_TILE, True),
    (32, 14, 338990, H100_CTAS, P.LONG_TILE, True),      # the hour's -c chunk
    (8, 14, 529673, H100_CTAS, P.LONG_TILE, False),      # 1.7 h: re-read
    (8, 14, 662092, H100_CTAS, P.LONG_TILE, False),      # 2 h broadcasts
    (3, 14, 2_000_000, H100_CTAS, P.LONG_TILE, False),   # 6.5 h
    (1, 14, 454656, H100_CTAS, P.LONG_TILE, True),       # the longest held
    (1, 14, 454657, H100_CTAS, P.LONG_TILE, False),      # one frame more
    (2048, 14, 10752, H100_CTAS, P.LONG_TILE, True),     # the staging slab
    (32, 14, 11925, H100_CTAS, P.LONG_TILE, True),       # a -c chunk
    (2048, 14, 33300, H100_CTAS, P.LONG_TILE, True),     # 3 tiles a row
    (9, 14, 4097, H100_CTAS, P.LONG_TILE, True),         # odd T
    (5, 14, 3, H100_CTAS, P.LONG_TILE, True),            # tiny
    (6, 5, 7, H100_CTAS, P.LONG_TILE, True),
    (40, 3, 1000, 48, 64, True),            # a file's tiles fill the grid
    (40, 3, 1000, 47, 64, False),           # one CTA short of that
    (9, 2, 700, 5, 50, False),
    (2, 5, 77, 400, 16, True),              # fewer tiles than CTAs
])
def test_long_plan(B, C, T, ctas, tile, resident):
    plan = P.long_plan(B, C, T, ctas, tile)
    assert 1 <= plan.grid <= ctas
    assert plan.resident == resident
    assert plan.tile <= tile
    # the row tiles partition [0, T): none empty
    assert (plan.tiles_per_row - 1) * plan.tile < T <= (
        plan.tiles_per_row * plan.tile)
    if resident:
        assert C * plan.tiles_per_row <= plan.grid
    assert 2 * B * C * plan.tiles_per_row < 2**31      # 32-bit offsets
    lens = _lens(B + T, B, T)
    _check_queue(plan, C, T, lens)
    # the queue makes progress (a file's shifts depend on its own tiles
    # only, so the first files stand for the rest where B is large)
    sim = lens[:max(5, 200_000 // (2 * C * plan.tiles_per_row))]
    assert _simulate(plan, C, T, sim) == 0


def test_the_simulation_sees_a_stall():
    """The negative control: holding a file's tiles on a grid one CTA too
    small for them stalls the queue, and the simulation says so."""
    C, T, tile = 3, 1000, 64
    plan = P.long_plan(40, C, T, 48, tile)
    assert plan.resident and plan.grid == 48
    assert _simulate(plan._replace(grid=47), C, T, [T] * 4) == 1
    assert _simulate(plan, C, T, [T] * 4) == 0
