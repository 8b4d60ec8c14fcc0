"""Device resolution for the port's entry points.

``train``, ``Booster`` and ``Dataset.construct`` take ``device=None``, which
means the CUDA card.  There is no silent CPU fallback: without a GPU,
``device=None`` raises ``NoCudaDeviceError``.  Callers that want the CPU (the
parity tests) pass ``device="cpu"`` explicitly; there every histogram runs
through its plain PyTorch version.
"""
from __future__ import annotations

import torch

from .utils.log import LightGBMError


class NoCudaDeviceError(LightGBMError):
    """``device`` resolved to CUDA but no CUDA device is present."""


class NotPortedError(LightGBMError):
    """A parameter or input asks for a path of the JAX package that this
    package has not ported yet (see ROADMAP.md queue A)."""


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"``/``"cuda"``/``"cuda:N"``/``torch.device``
    as given.  Raises ``NoCudaDeviceError`` for a CUDA device without a GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "device=%r needs a CUDA GPU and none is available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU"
                % (device,))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise LightGBMError(f"unsupported device {device!r} (cpu or cuda)")
    return dev
