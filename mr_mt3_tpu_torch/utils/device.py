"""Device selection: the port runs on the card unless asked for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None or 'cuda' -> the current CUDA device, raising if there is none;
    'cpu' -> the CPU. Nothing falls back to the CPU quietly."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {device!r}')
    return dev

