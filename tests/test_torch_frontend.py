"""The PyTorch port's front-end against the JAX package's, on the CPU.

Both packages get the same NumPy inputs, made from a seed.  Tolerances:

* port vs JAX features: 2e-5, the JAX package's own plan-invariance budget
  (docs/PARITY.md) — on signals whose every mel band sits well above the
  f32 FFT round-off floor;
* golden fixtures: 3e-5 (tests/test_golden.py) for the loudness row of every
  fixture and for all rows of the noise fixture.  The MFCC rows of the pure
  tone fixtures are the exception: their upper mel bands hold only FFT
  round-off (power ~1e-10, the size of ``MEL_LOG_FLOOR``), where two correct
  f32 FFTs (pocketfft here, ducc in XLA, cuFFT on the card) differ by ~10%
  per bin.  log10 turns that into ~0.05 per band and the DCT and the 0.1
  output scale into up to ~2e-2 per coefficient, so those rows are held to
  5e-2 and to the noise-free rows' exactness elsewhere.
"""

import numpy as np
import pytest
import torch

from strugatzki_tpu.dsp import frontend as JF
from strugatzki_tpu_torch.convert import basis_to_torch
from strugatzki_tpu_torch.dsp import frontend as PF
from strugatzki_tpu_torch.runtime import device as D
from test_golden import GOLDEN, _signals

SR = 44100.0


def _noisy(seed, seconds=2.0):
    """Tones over noise: every band well above the FFT round-off floor."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = np.interp(np.arange(n), np.linspace(0, n, 12),
                    rng.uniform(0.05, 1.0, 12))
    x = (0.3 * np.sin(2 * np.pi * 440 * t) * env
         + 0.1 * np.sin(2 * np.pi * 3100 * t)
         + 0.05 * rng.standard_normal(n) * env)
    return x.astype(np.float32)


def _pcm16(x):
    return np.round(np.clip(x, -1, 1 - 2 ** -15) * 32768.0).astype(np.int16)


@pytest.mark.parametrize("sr,fft,nc", [(44100.0, 1024, 13), (48000.0, 2048, 9)])
def test_make_basis_equals_jax(sr, fft, nc):
    a = JF.make_basis(sr, fft, nc)
    b = PF.make_basis(sr, fft, nc)
    for name in ("hann", "mel_fb", "dct", "erb_fb", "contours_ext",
                 "phons_ext", "thresh_db"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)
    assert b.power_cal_db == a.power_cal_db
    assert (b.sample_rate, b.fft_size, b.num_coeffs) == (sr, fft, nc)


@pytest.mark.parametrize("use_fft", [True, False])
def test_block_pipeline_matches_jax_extract_block(use_fft):
    import jax.numpy as jnp

    num_frames, fft, step = 256, 1024, 512
    x = _noisy(1, seconds=3.0)[:(num_frames - 1) * step + fft]
    rng = np.random.default_rng(2)
    carry = rng.uniform(0.0, 60.0, 42).astype(np.float32)
    basis = JF.make_basis(SR, fft, 13)
    consts = basis_to_torch(basis, "cpu")
    smask, tmask = np.float32(0.5), np.float32(0.5)

    fj, cj = JF._extract_block(
        jnp.asarray(x), jnp.asarray(carry), *JF._device_consts(
            SR, fft, 13, float(smask), float(tmask)),
        num_frames=num_frames, fft_size=fft, step=step, use_fft=use_fft,
        valid_frames=jnp.int32(200))
    fp, cp = PF._block_pipeline(
        torch.from_numpy(x), torch.from_numpy(carry), *consts,
        torch.tensor(smask), torch.tensor(tmask), num_frames=num_frames,
        fft_size=fft, step=step, use_fft=use_fft, valid_frames=200)
    np.testing.assert_allclose(fp.numpy(), np.asarray(fj), atol=2e-5)
    # the carry is band excitation in dB (20-70 here): a relative band-power
    # difference e between the two DFTs moves it by 4.3*e dB
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), rtol=1e-5)


def test_golden_fixtures():
    sr, signals = _signals()
    golden = np.load(GOLDEN)
    for name, x in signals.items():
        feats = PF.extract_features(x, sr, device="cpu")
        ref = golden[name]
        assert feats.shape == ref.shape
        np.testing.assert_allclose(feats[0], ref[0], atol=3e-5,
                                   err_msg=f"{name} loudness")
        # see the module docstring for the tonal fixtures' MFCC rows
        tol = 3e-5 if name == "noise" else 5e-2
        np.testing.assert_allclose(feats[1:], ref[1:], atol=tol,
                                   err_msg=f"{name} mfcc")


@pytest.mark.parametrize("pcm", [False, True])
def test_extract_features_matches_jax(pcm):
    x = _noisy(3)
    if pcm:
        x = _pcm16(x)
    fj = JF.extract_features(x, SR)
    fp = PF.extract_features(x, SR, device="cpu")
    assert fp.shape == fj.shape == (14, PF.num_output_frames(len(x), 512))
    np.testing.assert_allclose(fp, fj, atol=2e-5)


@pytest.mark.parametrize("pcm", [False, True])
def test_streaming_whole_and_batch_agree(pcm):
    xs = [_noisy(4), _noisy(5, seconds=1.3), _noisy(6, seconds=0.4)]
    if pcm:
        xs = [_pcm16(x) for x in xs]
    whole = [PF.extract_features(x, SR, device="cpu") for x in xs]

    # batch: one padded pass over all files, trimmed per file
    batch = PF.extract_features_batch(xs, SR, device="cpu")
    for x, w, b in zip(xs, whole, batch):
        np.testing.assert_allclose(b[:, :w.shape[1]], w, atol=2e-5)

    # streaming: 1024-frame chunks fed by ragged short reads, so the carry
    # crosses chunk seams
    x = xs[0]
    pos = 0
    sizes = iter([1000, 777, 5000] * 1000)

    def read(n):
        nonlocal pos
        k = min(n, next(sizes), len(x) - pos)
        pos += k
        return x[pos - k:pos]

    parts = []
    total = PF.extract_features_streaming(read, len(x), SR, parts.append,
                                          chunk_frames=1024, device="cpu")
    stream = np.concatenate(parts, axis=1)
    assert stream.shape[1] == total == whole[0].shape[1]
    np.testing.assert_allclose(stream, whole[0], atol=2e-5)

    # the JAX package's streaming output on the same reads
    pos = 0
    sizes = iter([1000, 777, 5000] * 1000)
    jparts = []
    JF.extract_features_streaming(read, len(x), SR, jparts.append,
                                  chunk_frames=1024)
    np.testing.assert_allclose(stream, np.concatenate(jparts, axis=1),
                               atol=2e-5)


def test_carry_at_last_valid_frame_under_padded_plan():
    """``return_carry`` gives the excitation at the last real frame, not at
    the plan's padded silence, as in the JAX package."""
    x = _noisy(7, seconds=1.0)
    step = 512
    cut = 40 * step
    whole = PF.extract_features(x, SR, device="cpu")
    first, carry = PF.extract_features(x[:cut], SR, device="cpu",
                                       return_carry=True)
    _, jcarry = JF.extract_features(x[:cut], SR, return_carry=True)
    np.testing.assert_allclose(carry.numpy(), np.asarray(jcarry), atol=1e-4)
    n = first.shape[1]
    np.testing.assert_allclose(first, whole[:, :n], atol=2e-5)


def test_precision_settings_pin_full_f32():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        assert D.resolve("cpu") == torch.device("cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        D.configure_precision()


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.resolve("cuda")
    with pytest.raises(RuntimeError):
        PF.extract_features(np.zeros(4096, np.float32), SR, device="cuda")
