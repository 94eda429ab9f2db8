"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and runs on ``cuda`` unless the
caller names another device. With no GPU present and no device named,
it RAISES: a silent fall-back to the CPU would hand a benchmark or a
deployment the plain PyTorch versions instead of the kernels.
"""

from __future__ import annotations

import subprocess
from typing import Optional

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device(device)``, or ``cuda`` when ``device`` is None.

    Raises ``RuntimeError`` when ``device`` is None and no CUDA device is
    available; pass ``device="cpu"`` to run the plain versions on the
    host explicitly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the host")
        return torch.device("cuda")
    return torch.device(device)


def nvidia_smi_line() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit``), or None where ``nvidia-smi`` is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (FileNotFoundError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
