"""Device selection and numeric settings for the PyTorch port.

Counterpart of ``strugatzki_tpu/runtime/platform.py``.  The device is always
explicit: :func:`resolve` turns a ``device`` argument into a
:class:`torch.device` and raises when CUDA is asked for but absent — nothing
is ever moved to the CPU without being asked.

Every float32 matmul on the parity paths runs at full f32, mirroring the JAX
package's ``Precision.HIGHEST`` (``dsp/frontend.py``): TF32 is switched off
for cuBLAS matmuls and cuDNN convolutions alike.
"""

from __future__ import annotations

import torch

__all__ = ["configure_precision", "resolve"]


def configure_precision() -> None:
    """Pin full-f32 matmuls (no TF32 on cuBLAS or cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve(device) -> torch.device:
    """``"cuda"``, ``"cuda:1"``, ``"cpu"`` or a :class:`torch.device` →
    :class:`torch.device`.  Raises ``RuntimeError`` for a CUDA device when
    ``torch.cuda.is_available()`` is false."""
    configure_precision()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
