"""Training losses (port of mr_mt3_tpu/train/losses.py).

Matches the reference tasks' loss math (reference: tasks/mt3_net.py:27-37
plain CE with ignore_index -100; :86-107 the 2x-instrument-weighted CE).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

IGNORE_INDEX = -100

# instrument (program) tokens in model space: codec program range 1132-1259
# shifted by 3 special tokens (reference: tasks/mt3_net.py:97-99)
INSTRUMENT_TOKEN_LO = 1135
INSTRUMENT_TOKEN_HI = 1262


def _per_token_ce(logits: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """-log p(target) per position, in f32; targets clipped for ignored
    slots."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    safe = torch.where(targets == IGNORE_INDEX, 0, targets).long()
    return -log_probs.gather(-1, safe[..., None])[..., 0]


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over non-ignored positions (torch CrossEntropyLoss
    semantics)."""
    ce = _per_token_ce(logits, targets)
    mask = targets != IGNORE_INDEX
    return (ce * mask).sum() / mask.sum().clamp(min=1)


def weighted_instrument_loss(
    logits: torch.Tensor, targets: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE with instrument (program) tokens double-weighted.

    loss = (sum_nonpad + 2 * sum_inst) / (n_inst + n_nonpad)
    (reference: tasks/mt3_net.py:97-107). Returns (loss, logs) where logs
    holds the split means the reference logs.
    """
    ce = _per_token_ce(logits, targets)
    pad_mask = targets != IGNORE_INDEX
    inst_mask = ((targets >= INSTRUMENT_TOKEN_LO) &
                 (targets <= INSTRUMENT_TOKEN_HI))
    n_other = pad_mask.sum()
    n_inst = inst_mask.sum()
    sum_other = (ce * pad_mask).sum()
    sum_inst = (ce * inst_mask).sum()
    loss = (sum_other + 2.0 * sum_inst) / (n_inst + n_other).clamp(min=1)
    logs = {
        # despite the name, 'loss_other' averages over ALL non-pad tokens
        # (instrument positions included) — bug-compatible with the
        # reference's train_loss_other, which divides loss_masked (the
        # full pad-masked CE) by its own count (tasks/mt3_net.py:109)
        'loss_other': sum_other / n_other.clamp(min=1),
        'loss_inst': sum_inst / n_inst.clamp(min=1),
    }
    return loss, logs
