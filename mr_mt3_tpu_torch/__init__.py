"""PyTorch/CUDA port of mr_mt3_tpu for NVIDIA Hopper (H100).

The port mirrors the JAX package's layout (models/, audio/, codec/, midi/,
ops/, infer/, utils/) so each module's counterpart is easy to find; the
CUDA sources of its hand-written kernels live in csrc/. It imports torch
and never jax, and nothing of mr_mt3_tpu: the numpy-only host layers
(codec, MIDI writer, WAV I/O, config loader) are carried as copies.

Entry points run on 'cuda' unless the caller passes device='cpu'.
"""

__version__ = '0.1.0'
