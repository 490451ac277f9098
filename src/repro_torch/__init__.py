"""PyTorch / CUDA port of the PQS package (``repro``) for NVIDIA Hopper.

The layout mirrors ``repro``: ``configs/``, ``core/``, ``kernels/``,
``models/``, ``serving/``. Every entry point runs on the CUDA device unless
the caller passes ``device="cpu"``; without a card and without that
request it raises instead of falling back (``resolve_device``).

This package imports torch, numpy and the standard library only — never
JAX and never the ``repro`` package.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller says.

    ``None`` means the CUDA device, and raises when there is none, so a
    missing card is never silently replaced by the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU explicitly"
        )
    return torch.device("cuda")
