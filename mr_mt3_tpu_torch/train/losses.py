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


def loss_terms(logits: torch.Tensor, targets: torch.Tensor,
               loss_type: str = 'ce') -> Dict[str, torch.Tensor]:
    """The sums and counts the loss is made of, over these rows: 'ce' the
    masked CE sum and its count of real tokens; 'weighted' the sums over
    real and over instrument tokens and their counts. Under data
    parallelism every rank reduces them (parallel.all_reduce_sum) so that
    the loss is the global batch's sum over its global count, as in the
    JAX package's one program over the global batch."""
    ce = _per_token_ce(logits, targets)
    pad_mask = targets != IGNORE_INDEX
    if loss_type != 'weighted':
        return {'sum': (ce * pad_mask).sum(), 'count': pad_mask.sum()}
    inst_mask = ((targets >= INSTRUMENT_TOKEN_LO) &
                 (targets <= INSTRUMENT_TOKEN_HI))
    return {'sum_other': (ce * pad_mask).sum(),
            'sum_inst': (ce * inst_mask).sum(),
            'n_other': pad_mask.sum(), 'n_inst': inst_mask.sum()}


def loss_from_terms(terms: Dict[str, torch.Tensor],
                    counts: Dict[str, torch.Tensor] = None,
                    scale: float = 1.0
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, logs) from loss_terms: the sums over the counts given (the
    terms' own by default; the global counts under data parallelism),
    times scale. cross_entropy_loss and weighted_instrument_loss are
    this on one batch."""
    counts = terms if counts is None else counts
    if 'sum' in terms:
        return terms['sum'] / counts['count'].clamp(min=1) * scale, {}
    n_other, n_inst = counts['n_other'], counts['n_inst']
    loss = ((terms['sum_other'] + 2.0 * terms['sum_inst'])
            / (n_inst + n_other).clamp(min=1) * scale)
    logs = {
        # despite the name, 'loss_other' averages over ALL non-pad tokens
        # (instrument positions included) — bug-compatible with the
        # reference's train_loss_other, which divides loss_masked (the
        # full pad-masked CE) by its own count (tasks/mt3_net.py:109)
        'loss_other': terms['sum_other'] / n_other.clamp(min=1) * scale,
        'loss_inst': terms['sum_inst'] / n_inst.clamp(min=1) * scale,
    }
    return loss, logs


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over non-ignored positions (torch CrossEntropyLoss
    semantics)."""
    return loss_from_terms(loss_terms(logits, targets, 'ce'))[0]


def weighted_instrument_loss(
    logits: torch.Tensor, targets: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE with instrument (program) tokens double-weighted.

    loss = (sum_nonpad + 2 * sum_inst) / (n_inst + n_nonpad)
    (reference: tasks/mt3_net.py:97-107). Returns (loss, logs) where logs
    holds the split means the reference logs.
    """
    return loss_from_terms(loss_terms(logits, targets, 'weighted'))
