"""The port's FFT trace family against the JAX package's and against the
float64 mirror of the reference math (``kernels/mathref.py``), on the CPU.

Tolerances: sims 3e-5 (the FFT round trip in f32 against the f64 mirror
and against XLA's FFT), boosts rtol 1e-4; NaN positions equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strugatzki_tpu.analysis import correlation as JC
from strugatzki_tpu.kernels import corr as JK
from strugatzki_tpu.kernels import mathref as M
from strugatzki_tpu.kernels.pallas_prep import prepare_database_xla
from strugatzki_tpu.parallel import sweep as JS
from strugatzki_tpu_torch.analysis import correlation as PC
from strugatzki_tpu_torch.convert import template_to_torch
from strugatzki_tpu_torch.kernels import corr as PK
from strugatzki_tpu_torch.parallel import sweep as PS
from test_kernels import _features, _reference_trace


def _template_args(tmpl, nt=1):
    L = tmpl.shape[1]
    tc_t, _, s_t = JK.prepare_template(tmpl[:nt])
    tc_s, _, s_s = JK.prepare_template(tmpl[nt:])
    ln_avg = float(np.log(np.float64(M.avg(tmpl[0], 0, L))))
    return tc_t, tc_s, s_t, s_s, ln_avg


def _both(xs, shift_t, tmpl, temp_weight, max_boost, nt=1):
    tc_t, tc_s, s_t, s_s, ln_avg = _template_args(tmpl, nt)
    js, jb = JK.correlation_trace(
        jnp.asarray(xs), jnp.asarray(tc_t), jnp.asarray(tc_s),
        jnp.float32(s_t), jnp.float32(s_s), jnp.float32(ln_avg),
        jnp.float32(shift_t), jnp.float32(temp_weight),
        jnp.float32(max_boost), num_temporal=nt)
    ps, pb = PK.correlation_trace(
        torch.from_numpy(xs), torch.from_numpy(tc_t), torch.from_numpy(tc_s),
        s_t, s_s, ln_avg, shift_t, temp_weight, max_boost, num_temporal=nt)
    return (ps.numpy(), pb.numpy()), (np.asarray(js), np.asarray(jb))


def _close(a, b, sim_atol=3e-5, boost_rtol=1e-4, gate=None):
    """Sims within ``sim_atol``, boosts within ``boost_rtol``, NaN boosts at
    the same windows.  With a ``gate`` (``max_boost``) the gate's positions
    are equal and boosts are compared where they pass it: past it a
    window's loudness mean is tiny, and an FFT window sum's round-off is
    large against it (its sim is 0 in both)."""
    (sa, ba), (sb, bb) = a, b
    assert sa.shape == sb.shape and sa.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(ba), np.isnan(bb))
    np.testing.assert_allclose(sa, sb, atol=sim_atol)
    if gate is not None:
        np.testing.assert_array_equal(ba <= gate, bb <= gate)
        ba, bb = ba[bb <= gate], bb[bb <= gate]
    np.testing.assert_allclose(ba, bb, rtol=boost_rtol)


@pytest.mark.parametrize("temp_weight", [0.0, 0.5, 1.0])
def test_correlation_trace_matches_jax_and_mirror(temp_weight):
    x = _features(C=14, T=300, seed=7)
    L = 40
    xs, shift_t, _ = PK.shift_per_group(x)
    port, jax_ = _both(xs, shift_t, x[:, 50:50 + L], temp_weight, 8.0)
    _close(port, jax_)
    _close(port, _reference_trace(x, 50, L, temp_weight, max_boost=8.0))
    assert abs(port[0][50] - 1.0) < 1e-4


def test_boost_gate_rejects_nan_and_large_boosts():
    """Windows whose boost is not <= max_boost get sim 0: a huge boost from
    a quiet region, and NaN from a window whose loudness mean is negative
    (log of a negative number)."""
    x = _features(C=4, T=200, seed=9)
    x[0, 100:140] *= 0.001              # quiet: boost far above max_boost
    x[0, 150:200] = -0.3                # negative mean: NaN boost
    L = 40
    xs, shift_t, _ = PK.shift_per_group(x)
    port, jax_ = _both(xs, shift_t, x[:, 20:20 + L], 0.5, 8.0)
    _close(port, jax_)
    sims, boosts = port
    nan = np.isnan(boosts)
    big = boosts > 8.0
    assert nan.any() and big.any()
    assert (sims[nan | big] == 0.0).all()
    assert (sims[~(nan | big)] != 0.0).all()


def test_unused_degenerate_group_stays_out():
    """temp_weight 0 skips the temporal group: a constant loudness row
    (zero std, 0/0 in its correlation) must not reach the sims."""
    x = _features(C=5, T=160, seed=4)
    x[0] = 0.4
    L = 30
    xs, shift_t, _ = PK.shift_per_group(x)
    port, jax_ = _both(xs, shift_t, x[:, 10:10 + L], 0.0, 8.0)
    assert np.isfinite(port[0]).all()
    _close(port, jax_)


def test_multi_temporal_boost_uses_channel0():
    x = _features(C=6, T=160, seed=11)
    L = 24
    xs, shift_t, _ = PK.shift_per_group(x, num_temporal=2)
    port, jax_ = _both(xs, shift_t, x[:, 30:30 + L], 0.5, 8.0, nt=2)
    _close(port, jax_)


def test_batched_traces_match_jax():
    mats = [_features(C=14, T=t, seed=s) for s, t in
            ((1, 300), (2, 180), (3, 256), (4, 90))]
    raw, lens = PS.pad_stack(mats)
    norm = np.stack([raw.min(axis=(0, 2)) - 0.01,
                     raw.max(axis=(0, 2)) + 0.01], axis=1).astype(np.float32)
    xs, shifts = prepare_database_xla(jnp.asarray(raw), jnp.asarray(norm),
                                      jnp.asarray(lens))
    xs, shifts = np.array(xs), np.array(shifts)

    block = mats[0][:, 100:140].copy()
    M.normalize(norm, block, 0, 40)
    jt = JC.InputTemplate(block)
    pt = template_to_torch(jt, "cpu")
    own = PC.InputTemplate(block)
    for name in ("temporal_std", "spectral_std", "ln_avg_loudness",
                 "temporal_mean", "spectral_mean"):
        assert getattr(own, name) == getattr(jt, name)
    np.testing.assert_array_equal(own.temporal_centered, jt.temporal_centered)
    np.testing.assert_array_equal(own.spectral_centered, jt.spectral_centered)

    for tw in (0.0, 0.5, 1.0):
        js, jb = JS.batched_correlation_traces(xs, shifts, jt, tw, 8.0)
        ps, pb = PS.batched_correlation_traces(xs, shifts, pt, tw, 8.0,
                                               device="cpu")
        for b, n in enumerate(lens):
            w = n - 40 + 1
            _close((ps[b, :w], pb[b, :w]), (js[b, :w], jb[b, :w]))


def test_sliding_dot_fft_matches_direct():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 2, 50)).astype(np.float32)
    tmpl = rng.standard_normal((2, 7)).astype(np.float32)
    out = PK.sliding_dot_fft(torch.from_numpy(tmpl), torch.from_numpy(x))
    direct = np.stack([[np.sum(tmpl * xb[:, t:t + 7]) for t in range(44)]
                       for xb in x])
    np.testing.assert_allclose(out.numpy(), direct, atol=1e-5)
    with pytest.raises(ValueError):
        PK.sliding_dot_fft(torch.from_numpy(tmpl), torch.zeros(2, 5))


def test_copied_host_helpers_equal_the_originals():
    x = _features(C=6, T=77, seed=2)
    for a, b in zip(PK.prepare_template(x), JK.prepare_template(x)):
        np.testing.assert_array_equal(a, b)
    for nt in (0, 1, 2):
        for a, b in zip(PK.shift_per_group(x, nt), JK.shift_per_group(x, nt)):
            np.testing.assert_array_equal(a, b)
    mats = [x, x[:, :30], x[:, :1]]
    for multiple in (1, 8):
        for a, b in zip(PS.pad_stack(mats, -1.0, multiple),
                        JS.pad_stack(mats, -1.0, multiple)):
            np.testing.assert_array_equal(a, b)
    for n in (0, 1, 1024, 1025, 10335, 123456):
        assert PC._bucket(n) == JC._bucket(n)
    for n in (1, 2, 5, 100, 4097):
        assert PK._fft_len(n) == JK._fft_len(n)


@pytest.mark.parametrize("scan_len", [200, 35, 0])
def test_sliding_traces_match_jax(scan_len):
    """Whole scans and the single zero-tailed window of a scan shorter than
    the template (``scan_len < L``)."""
    x = _features(C=14, T=220, seed=13)
    block = x[:, 60:100].copy()
    xs, sh_t, sh_s = PK.shift_per_group(x)
    jt = JC.InputTemplate(block)
    js, jb = JC.sliding_traces(xs, sh_t, sh_s, jt, scan_len, 0.5, 8.0)
    ps, pb = PC.sliding_traces(xs, sh_t, sh_s, PC.InputTemplate(block),
                               scan_len, 0.5, 8.0, device="cpu")
    _close((ps, pb), (js, jb))
    if scan_len == 200:
        assert int(np.argmax(ps)) == 60 and abs(ps[60] - 1.0) < 1e-4


# -- the compact cache: forward spectra, planar packing, window-sum tables --

EPS32 = float(np.finfo(np.float32).eps)
#: a float32 prefix row's error in units of ``eps32 · max|P|`` of the row:
#: measured up to ~21 (a centered row's sum wanders through partial sums far
#: above its final magnitude) in both packages at T = 3000
TABLE_C = 64


def _f64_table(xs, nt):
    """The window-sum table's rows and prefixes in float64."""
    x = np.asarray(xs, np.float64)
    rows = [x[:nt].sum(0), (x[:nt] ** 2).sum(0), x[nt:].sum(0),
            (x[nt:] ** 2).sum(0)] + ([x[0]] if nt != 1 else [])
    r = np.stack(rows)
    return np.concatenate([np.zeros((r.shape[0], 1)), np.cumsum(r, 1)], 1)


def _table_bound(P):
    """Per row: the absolute error a float32 prefix may carry."""
    return TABLE_C * EPS32 * np.abs(P).max(axis=1, keepdims=True)


@pytest.mark.parametrize("T,nt", [(300, 1), (300, 2), (3000, 1), (3000, 2)])
def test_window_sum_table_matches_f64_prefix_and_jax(T, nt):
    """The float32 table against an f64 prefix within ``TABLE_C · eps32 ·
    max|P|`` per row (absolute in the prefix magnitude: the scan orders of
    ``torch.cumsum`` and XLA differ, the bound holds for both), and window
    sums, a difference of two prefixes, within twice that."""
    x = _features(C=14, T=T, seed=3)
    xs, _, _ = PK.shift_per_group(x, nt)
    p = PK.window_sum_table(torch.from_numpy(xs), nt).numpy()
    j = np.asarray(JK.window_sum_table(jnp.asarray(xs), nt))
    P = _f64_table(xs, nt)
    bound = _table_bound(P)
    assert p.shape == j.shape == P.shape == (4 if nt == 1 else 5, T + 1)
    assert p.dtype == np.float32 and (p[:, 0] == 0).all()
    assert (np.abs(p - P) <= bound).all()
    assert (np.abs(j - P) <= bound).all()
    L = 40
    W = T - L + 1
    assert (np.abs((p[:, L:] - p[:, :W]) - (P[:, L:] - P[:, :W]))
            <= 2 * bound).all()
    # batched rows: the same table per file
    both = PK.window_sum_table(torch.from_numpy(np.stack([xs, xs[::-1]])),
                               nt).numpy()
    np.testing.assert_array_equal(both[0], p)


def _sums_tol(xs, L, nt):
    """3e-5 (the FFT trace's budget) plus the table's share: a window sum
    carries up to twice :func:`_table_bound`, which moves a group's window
    variance by ``δq/n + 2|μ|·δs/n`` and its sim by at most half the
    relative change.  A group whose window variance is zero somewhere (a
    constant group) adds nothing: its sims are 0/0, NaN in both packages,
    compared by position."""
    P = _f64_table(xs, nt)
    d = 2 * _table_bound(P)[:, 0]
    W = xs.shape[1] - L + 1
    tol = 3e-5
    for rs, rq, n in ((0, 1, nt * L), (2, 3, (xs.shape[0] - nt) * L)):
        mu = (P[rs, L:] - P[rs, :W]) / n
        var = (P[rq, L:] - P[rq, :W]) / n - mu * mu
        if var.min() <= 0:
            continue
        tol += 0.5 * (d[rq] / n + 2 * np.abs(mu).max() * d[rs] / n) \
            / var.min()
    return tol


@pytest.mark.parametrize("T,L,nt", [(300, 40, 1), (300, 24, 2),
                                    (3000, 400, 1)])
def test_correlation_trace_from_sums_matches_jax(T, L, nt):
    """The 2-irfft trace from forward spectra and a window-sum table
    (``correlation_traces`` on the sums path) against the JAX package's
    ``correlation_trace_from_sums`` and against the port's FFT-window-sum
    trace, within the FFT budget plus the table's share
    (:func:`_sums_tol`)."""
    x = _features(C=14, T=T, seed=7)
    xs, sh, _ = PK.shift_per_group(x, nt)
    tc_t, tc_s, s_t, s_s, ln = _template_args(x[:, 50:50 + L], nt)
    xt = torch.from_numpy(xs)

    def traces(t_t, t_s, std_t, std_s, ln_avg):
        return PK.correlation_traces(
            PK.forward_spectra(xt), PK.window_sum_table(xt, nt), True, T,
            [PK.TraceTemplate(t_t, t_s, std_t, std_s, ln_avg, 0.5)], sh, 8.0,
            num_temporal=nt)[0]
    ps, pb = traces(torch.from_numpy(tc_t), torch.from_numpy(tc_s), s_t, s_s,
                    ln)
    xj = jnp.asarray(xs)
    js, jb = JK.correlation_trace_from_sums(
        JK.forward_spectra(xj), JK.window_sum_table(xj, nt), T,
        jnp.asarray(tc_t), jnp.asarray(tc_s), jnp.float32(s_t),
        jnp.float32(s_s), jnp.float32(ln), jnp.float32(sh),
        jnp.float32(0.5), jnp.float32(8.0), num_temporal=nt)
    fft = PK.correlation_trace(xt, torch.from_numpy(tc_t),
                               torch.from_numpy(tc_s), s_t, s_s, ln, sh,
                               0.5, 8.0, num_temporal=nt)
    tol = _sums_tol(xs, L, nt)
    # the worst case of the table's share (1.6e-4 to 3.2e-4 here) stays an
    # order below the compact mode's 4e-3 raw budget
    assert tol < 4e-4
    port = (ps.numpy(), pb.numpy())
    _close(port, (np.asarray(js), np.asarray(jb)), sim_atol=tol)
    _close(port, (fft[0].numpy(), fft[1].numpy()), sim_atol=tol)
    assert abs(port[0][50] - 1.0) < 1e-4
    with pytest.raises(ValueError, match="exceeds"):
        traces(torch.zeros(nt, T + 1), torch.zeros(14 - nt, T + 1), 1.0, 1.0,
               0.0)


def test_forward_spectra_and_planar_packing_match_jax():
    """``forward_spectra`` is ``trace_spectra``'s ``X`` and the JAX
    package's within f32 FFT round-off (5e-7 of the largest bin); bf16
    packing of the same complex values is bit for bit the JAX package's
    (round to nearest even), and unpacking restores complex64."""
    x = _features(C=14, T=300, seed=5)
    xs, _, _ = PK.shift_per_group(x)
    X = PK.forward_spectra(torch.from_numpy(xs))
    assert X.dtype == torch.complex64 and X.shape == (14, 257)
    assert torch.equal(X, PK.trace_spectra(torch.from_numpy(xs))[0])
    Xj = np.asarray(JK.forward_spectra(jnp.asarray(xs)))
    scale = np.abs(Xj).max()
    np.testing.assert_allclose(X.numpy(), Xj, atol=5e-7 * scale)
    re, im = PK.pack_spectra(X)
    jre, jim = JK.pack_spectra(jnp.asarray(X.numpy()))
    assert re.dtype == im.dtype == torch.bfloat16
    np.testing.assert_array_equal(re.float().numpy(),
                                  np.asarray(jre, np.float32))
    np.testing.assert_array_equal(im.float().numpy(),
                                  np.asarray(jim, np.float32))
    back = PK.unpack_spectra(re, im)
    assert back.dtype == torch.complex64
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JK.unpack_spectra(jre, jim)))
    # bf16 keeps 8 bits: each part within 2^-9 of its magnitude
    err = np.abs(back.numpy() - X.numpy())
    assert (err <= 2.0 ** -8 * np.abs(X.numpy()) + 1e-30).all()
    f16 = PK.pack_spectra(X, torch.float16)
    assert f16[0].dtype == torch.float16


# ---------------------------------------------------------------------------
# trace groups (``correlation_traces``): the plain path on the CPU
# ---------------------------------------------------------------------------

def _group_case(nt, lengths, weights, seed=3, B=3, C=6, T=220):
    """Files ``[B, C, T]`` (one with a constant temporal group, one with a
    quiet stretch and a negative-loudness stretch, so the temporal group
    degenerates and both boost gates fire), each shifted per group, and
    the templates of ``lengths`` cut from file 1."""
    x = np.stack([_features(C=C, T=T, seed=seed + b) for b in range(B)])
    x[0, :nt] = 0.4                     # zero temporal std: 0/0 sims
    x[2, 0, 100:140] *= 0.001           # boost far above max_boost
    x[2, 0, 160:200] = -0.3             # negative mean: NaN boost
    xs, shifts = zip(*(PK.shift_per_group(f, nt)[:2] for f in x))
    xs = torch.from_numpy(np.stack(xs))
    templates = []
    for i, (L, w) in enumerate(zip(lengths, weights)):
        PT = PC.InputTemplate(x[1, :, 20 + 30 * i:20 + 30 * i + L], nt)
        templates.append(PT.trace_template("cpu", PK._fft_len(T), w))
    return xs, torch.tensor(shifts, dtype=torch.float32), templates


def _per_template(X, aux, use_sums, T, templates, shifts, nt):
    """Each template traced as a group of its own."""
    return [PK.correlation_traces(X, aux, use_sums, T, [t], shifts, 8.0,
                                  num_temporal=nt)[0] for t in templates]


def _per_template_jax(X, aux, use_sums, T, templates, shifts, nt):
    """Each template through the JAX package's per-template trace, file by
    file → ``[(sims [B, W], boosts [B, W])]`` as numpy arrays."""
    fn = (JK.correlation_trace_from_sums if use_sums
          else JK.correlation_trace_from_spectra)
    out = []
    for t in templates:
        files = [fn(jnp.asarray(X[b].numpy()), jnp.asarray(aux[b].numpy()),
                    T, jnp.asarray(t.temporal.numpy()),
                    jnp.asarray(t.spectral.numpy()), jnp.float32(t.std_t),
                    jnp.float32(t.std_s), jnp.float32(t.ln_avg_loud),
                    jnp.float32(shifts[b]), jnp.float32(t.temp_weight),
                    jnp.float32(8.0), num_temporal=nt)
                 for b in range(X.shape[0])]
        out.append(tuple(np.stack([np.asarray(f[i]) for f in files])
                         for i in range(2)))
    return out


def _bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


GROUPS = [((40,), (0.5,)), ((40, 24), (0.5, 0.5)), ((40, 24), (0.0, 1.0)),
          ((40, 40), (0.25, 0.0))]


@pytest.mark.parametrize("use_sums", [False, True])
@pytest.mark.parametrize("nt", [1, 2])
@pytest.mark.parametrize("lengths,weights", GROUPS)
def test_trace_group_plain_path_is_per_template_bits(lengths, weights, nt,
                                                     use_sums):
    """On the CPU a trace group runs the kernels' plain versions (the plan's
    rows, one batched irfft, the epilogue) and equals the same templates
    traced one at a time, bit for bit, on the default thread count: one
    and two templates of different and equal lengths, ``nt`` 1 and 2, both
    cache paths, a degenerate temporal group left out by a zero weight,
    the NaN and large-boost gates.  Each template is within the parity
    budget of the JAX package's per-template trace (sims 3e-5, on the sums
    path plus the table's share, :func:`_sums_tol`; boosts 1e-4 where they
    pass the gate; NaN and gate positions equal)."""
    xs, shifts, templates = _group_case(nt, lengths, weights)
    T = xs.shape[-1]
    if use_sums:
        X, aux = PK.forward_spectra(xs), PK.window_sum_table(xs, nt)
    else:
        X, aux = PK.trace_spectra(xs, num_temporal=nt)
    want = _per_template(X, aux, use_sums, T, templates, shifts, nt)
    calls, launches = PK.REFERENCE_CALLS, PK.KERNEL_LAUNCHES
    got = PK.correlation_traces(X, aux, use_sums, T, templates, shifts, 8.0,
                                num_temporal=nt)
    assert PK.REFERENCE_CALLS - calls == len(templates)
    assert PK.KERNEL_LAUNCHES == launches
    assert len(got) == len(want)
    for (gs, gb), (ws, wb) in zip(got, want):
        assert _bits(gs, ws) and _bits(gb, wb)

    plan = PK.trace_plan(T, lengths, weights, use_sums, nt)
    rows = PK.trace_rows_reference(X, None if use_sums else aux,
                                   [t.spectrum for t in templates], plan, nt)
    assert rows.shape == (xs.shape[0], plan.rows, plan.n_fft // 2 + 1)
    jax_ = _per_template_jax(X, aux, use_sums, T, templates, shifts, nt)
    for L, (s, bo), (js, jb) in zip(lengths, got, jax_):
        for b in range(xs.shape[0]):
            tol = _sums_tol(xs[b].numpy(), L, nt) if use_sums else 3e-5
            _close((s[b].numpy(), bo[b].numpy()), (js[b], jb[b]),
                   sim_atol=tol, gate=8.0)
    # the degenerate temporal group reaches the sims only where weighed
    for t, (s, b) in zip(templates, want):
        assert np.isnan(b[2].numpy()).any() and (b[2] > 8.0).any()
        assert (s[~(b <= 8.0)] == 0).all()
        assert np.isfinite(s[0].numpy()).all() == (t.temp_weight == 0.0)


def test_trace_plan_lays_out_rows():
    """Window-sum blocks once per distinct length (none on the sums path),
    then each template's dots where the blend weighs its group; a template
    longer than the files raises as the per-template functions do."""
    p = PK.trace_plan(300, (40, 24, 40), (0.5, 0.0, 1.0), False, 1)
    assert p.ones == (40, 24) and p.n_sum == 4
    assert p.bases == (0, 4, 0)
    assert p.dots == ((8, 9), (-1, 10), (11, -1)) and p.rows == 12
    assert p.n_fft == 512
    p = PK.trace_plan(300, (40, 24), (0.5, 0.5), False, 2)
    assert p.bases == (0, 5) and p.dots == ((10, 11), (12, 13))
    p = PK.trace_plan(300, (40, 24), (0.5, 1.0), True, 2)
    assert p.ones == () and p.bases == (-1, -1) and p.n_sum == 5
    assert p.dots == ((0, 1), (2, -1)) and p.rows == 3
    with pytest.raises(ValueError, match="exceeds"):
        PK.trace_plan(300, (40, 301), (0.5, 0.5), False, 1)


def test_trace_kernels_take_cuda_tensors_only():
    xs, shifts, templates = _group_case(1, (40,), (0.5,))
    X, Xsq = PK.trace_spectra(xs)
    with pytest.raises(ValueError, match="CUDA"):
        PK.correlation_traces_cuda(X, Xsq, False, xs.shape[-1], templates,
                                   shifts, 8.0)


@pytest.mark.parametrize("nt", [1, 2])
def test_template_spectrum_cache(nt):
    """``InputTemplate.device_spectrum`` holds one entry per device and FFT
    length, each ``conj(rfft)`` of the centered groups at that length."""
    x = _features(C=6, T=120, seed=2)
    t = PC.InputTemplate(x[:, 10:50], nt)
    a = t.device_spectrum("cpu", 64)
    assert t.device_spectrum("cpu", 64) is a
    b = t.device_spectrum("cpu", 128)
    assert b is not a and b.shape == (6, 65) and a.shape == (6, 33)
    assert len([k for k in t._staged if k[0] == "f"]) == 2
    for n, s in ((64, a), (128, b)):
        want = torch.cat([torch.fft.rfft(torch.from_numpy(
            t.temporal_centered), n=n), torch.fft.rfft(torch.from_numpy(
                t.spectral_centered), n=n)]).conj()
        assert s.dtype == torch.complex64
        assert torch.equal(s, want.resolve_conj())
    tt = t.trace_template("cpu", 128, 0.25)
    assert tt.spectrum is b and tt.temp_weight == 0.25
    assert (tt.std_t, tt.std_s, tt.ln_avg_loud) == (
        t.temporal_std, t.spectral_std, t.ln_avg_loudness)
