"""Moving the JAX package's constants into the port.

This system has no model weights: what both packages must share is the
front-end basis (``make_basis``) and the staged correlation templates.  The
tests build them once with the JAX package and hand them to the port
through these functions, so that both packages run on identical constants.
"""

from __future__ import annotations

import torch

from .runtime.device import resolve

__all__ = ["basis_to_torch", "template_to_torch"]

#: host fields of an ``InputTemplate`` (either package's)
_TEMPLATE_FIELDS = ("num_frames", "num_temporal", "temporal_block",
                    "spectral_block", "temporal_centered", "temporal_mean",
                    "temporal_std", "spectral_centered", "spectral_mean",
                    "spectral_std", "ln_avg_loudness")


def basis_to_torch(basis, device):
    """A ``FrontendBasis`` of NumPy arrays (from either package's
    ``make_basis``) → the frontend's basis tensors on ``device``:
    ``(hann, mel_fb, dct, erb_fb, power_cal_db, contours_ext, phons_ext,
    thresh_db)``, all float32 (``power_cal_db`` a 0-dim tensor)."""
    dev = resolve(device)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    return (t(basis.hann), t(basis.mel_fb), t(basis.dct), t(basis.erb_fb),
            t(basis.power_cal_db), t(basis.contours_ext),
            t(basis.phons_ext), t(basis.thresh_db))


def template_to_torch(tmpl, device):
    """A JAX-side ``analysis.correlation.InputTemplate`` → the port's
    :class:`~strugatzki_tpu_torch.analysis.correlation.InputTemplate` with
    the same host statistics and its centered groups staged on ``device``."""
    from .analysis.correlation import InputTemplate

    out = InputTemplate.__new__(InputTemplate)
    for name in _TEMPLATE_FIELDS:
        setattr(out, name, getattr(tmpl, name))
    out._staged = {}
    out.device_temporal(device)
    out.device_spectral(device)
    return out
