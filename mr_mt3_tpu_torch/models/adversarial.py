"""Adversarial input-noise attacks on the encoder inputs.

Port of mr_mt3_tpu/models/adversarial.py (the reference's T5Adversarial
helpers, reference: models/t5.py:370-394): FGSM and PGD-linf perturb the
mel inputs to raise the CE loss while the labels stay fixed, an encoder
robustness probe. The loss is train/losses.py::cross_entropy_loss on the
model's teacher-forced logits (labels shifted right, eval mode: no
dropout); a segment-memory model remembers within the batch, from the
labels, as its forward does without targets_prev. The gradient is taken
with torch.autograd.grad on the inputs alone, so no parameter gradient is
kept. On the card a bfloat16 model's long attentions (L >= 512) run the
fused attention kernels forward and backward.
"""

from __future__ import annotations

import torch

from mr_mt3_tpu_torch.models.mt3 import MT3
from mr_mt3_tpu_torch.train.losses import cross_entropy_loss


def input_loss(model: MT3, inputs: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """CE of the model's teacher-forced logits on (inputs, labels), in eval
    mode (the module's mode is restored)."""
    was_training = model.training
    model.eval()
    try:
        return cross_entropy_loss(model(inputs, labels=labels), labels)
    finally:
        model.train(was_training)


def input_gradient(model: MT3, inputs: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """d loss / d inputs, in the inputs' dtype."""
    x = inputs.detach().requires_grad_(True)
    with torch.enable_grad():
        (grad,) = torch.autograd.grad(input_loss(model, x, labels), x)
    return grad


def fgsm(model: MT3, inputs: torch.Tensor, labels: torch.Tensor,
         epsilon: float = 0.1) -> torch.Tensor:
    """One-step sign-of-gradient perturbation (reference: :374-381)."""
    return epsilon * torch.sign(input_gradient(model, inputs, labels))


def pgd_linf(model: MT3, inputs: torch.Tensor, labels: torch.Tensor,
             epsilon: float = 0.1, alpha: float = 0.01,
             num_iter: int = 5) -> torch.Tensor:
    """Projected gradient descent in the l-inf ball (reference: :383-394):
    num_iter signed steps of alpha from zero, each clipped to +-epsilon."""
    delta = torch.zeros_like(inputs)
    for _ in range(num_iter):
        g = input_gradient(model, inputs + delta, labels)
        delta = torch.clamp(delta + alpha * torch.sign(g), -epsilon, epsilon)
    return delta
