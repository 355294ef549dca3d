"""Device selection: the port runs on the card unless the caller asks for
the CPU, and never falls back to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device=cpu) to run on the CPU"
        )
    return dev
