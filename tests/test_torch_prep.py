"""The port's database preparation on the CPU against the JAX package's
Pallas kernel (interpret mode) and its XLA formulation.

On the CPU the port runs ``prepare_database_reference``, the plain
PyTorch version that ``chip_smoke.py`` holds the CUDA kernel to on the card.
Tolerances: values and shifts atol 1e-6 (f32 sums over at most 1,200
elements in another order); NaN and inf positions equal; frames at or past
a file's length exactly ``-shift``.
"""

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


@pytest.mark.parametrize("B,C,T,want", [
    (2048, 14, 10752, 8),      # the staging slab: 8 CTAs of 73.5 KiB
    (32, 14, 11925, 16),       # a -c chunk: one wave, spread twice as wide
    (7, 14, 3000, 6),
    (2048, 14, 33000, 8),      # the longest files a cluster holds
    (2048, 14, 33300, None),   # longer: the two-pass kernel
    (65, 14, 40448, None),
    (5, 14, 3, 2),
])
def test_one_pass_cluster_rule(B, C, T, want):
    """The wrapper's choice between the kernels, made from the shape alone
    (132 SMs, an H100 SXM): a cluster size where a file fits 8 CTAs'
    shared memory, None where it does not."""
    nc = P.one_pass_cluster(B, C, T, 132)
    assert nc == want
    if nc is not None:
        assert P.one_pass_smem(C, T, nc) <= P._MAX_DYN_SMEM
        assert nc * P.one_pass_smem(C, T, nc) >= C * T * 4
    else:
        assert P.one_pass_smem(C, T, P.MAX_CLUSTER) > P._MAX_DYN_SMEM


def test_variant_counters_stay_apart_from_the_reference():
    feats, lens, norm = _batch(seed=1)
    before = (P.KERNEL_LAUNCHES, P.ONE_PASS_LAUNCHES, P.TWO_PASS_LAUNCHES)
    P.prepare_database(feats, norm, lens, device="cpu")
    assert (P.KERNEL_LAUNCHES, P.ONE_PASS_LAUNCHES,
            P.TWO_PASS_LAUNCHES) == before
    assert P.KERNEL_LAUNCHES == P.ONE_PASS_LAUNCHES + P.TWO_PASS_LAUNCHES
