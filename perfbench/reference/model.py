"""MT3 and the MR-MT3 segment-memory model as plain float32 PyTorch.

A frozen, independent statement of the architecture (arXiv 2111.03017;
arXiv 2403.10024): a linear input projection of the log-mel frames, T5
blocks with pre-norm residuals, RMS norms, unscaled dot-product attention
with no relative bias, additive sinusoidal positions (a sin block, then a
cos block), a gated feed-forward with tanh-approximate GELU, an untied
output head; for the segment-memory model a one-block encoder over the
previous segment's tokens, embedded with the decoder's embedding, cut to
segmem_length rows and appended to the audio encoder's output.

Weights are the benchmark's, made from the seed by `make_weights` and
handed to the program and to this reference alike, under the names the
program's state dict uses. Matmuls run with TF32 off unless a control asks
for it.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

Weights = Dict[str, torch.Tensor]


def param_shapes(sizes: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every parameter of the model with its shape, in a fixed order."""
    D, F, V = sizes['d_model'], sizes['d_ff'], sizes['vocab_size']
    inner = sizes['num_heads'] * sizes['d_kv']
    out = [('proj.weight', (D, sizes['mel_bins'])),
           ('decoder_embed_tokens.weight', (V, D))]

    def attention(prefix):
        return [(f'{prefix}.q.weight', (inner, D)),
                (f'{prefix}.k.weight', (inner, D)),
                (f'{prefix}.v.weight', (inner, D)),
                (f'{prefix}.o.weight', (D, inner))]

    def ff(prefix):
        return [(f'{prefix}.wi_0.weight', (F, D)),
                (f'{prefix}.wi_1.weight', (F, D)),
                (f'{prefix}.wo.weight', (D, F))]

    def stack(name, layers, decoder):
        rows = []
        for i in range(layers):
            b = f'{name}.block.{i}.layer'
            rows += attention(f'{b}.0.SelfAttention')
            rows.append((f'{b}.0.layer_norm.weight', (D,)))
            n = 1
            if decoder:
                rows += attention(f'{b}.1.EncDecAttention')
                rows.append((f'{b}.1.layer_norm.weight', (D,)))
                n = 2
            rows += ff(f'{b}.{n}.DenseReluDense')
            rows.append((f'{b}.{n}.layer_norm.weight', (D,)))
        rows.append((f'{name}.final_layer_norm.weight', (D,)))
        return rows

    out += stack('encoder', sizes['num_layers'], False)
    out += stack('decoder', sizes['num_decoder_layers'], True)
    out.append(('lm_head.weight', (V, D)))
    if sizes.get('segmem_length'):
        out += stack('segmem_encoder', sizes['segmem_num_layers'], False)
    return out


def init_std(name: str, shape, sizes: dict) -> float:
    """The standard deviation of a matrix at initialization, as T5 (which
    MT3 is) draws it (HF T5PreTrainedModel._init_weights, factor 1): the
    embedding and the output head 1; q (d_model d_kv)^-1/2, which takes
    the place of the 1/sqrt(d_kv) the attention leaves out; every other
    matrix fan_in^-1/2 (k, v and wi d_model, o inner, wo d_ff), and the
    input projection of the log-mel frames mel_bins^-1/2."""
    if name in ('decoder_embed_tokens.weight', 'lm_head.weight'):
        return 1.0
    if name.endswith('.q.weight'):
        return (sizes['d_model'] * sizes['d_kv']) ** -0.5
    return shape[1] ** -0.5


@torch.no_grad()
def make_weights(sizes: dict, seed: int, device) -> Weights:
    """Seeded random weights on `device`, float32: every matrix normal
    with init_std's deviation, every norm ones. One normal draw from a
    generator on the device fills all matrices."""
    shapes = param_shapes(sizes)
    mats = [(n, s) for n, s in shapes if len(s) == 2]
    total = sum(math.prod(s) for _, s in mats)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes:
        if len(shape) == 1:
            out[name] = torch.ones(shape, device=device)
            continue
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape) * init_std(name, shape,
                                                             sizes)
        off += n
    return out


def sinusoid_table(dim: int, length: int) -> torch.Tensor:
    """(length, dim) float32: [sin(t w_i) | cos(t w_i)], w_i =
    10000^(-2i / dim), computed in float64."""
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    ang = np.outer(np.arange(length, dtype=np.float64), inv)
    return torch.from_numpy(np.concatenate([np.sin(ang), np.cos(ang)], -1)
                            .astype(np.float32))


def rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return weight * (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


@contextmanager
def tf32(on: bool):
    """Matmul precision: TF32 on or off for the block (off is the
    reference's; a control may ask for on)."""
    old = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def encoder_stack(w: Weights, name: str, x: torch.Tensor, sizes: dict,
                  layers: int, rnd: Callable = identity,
                  round_scores: bool = True) -> torch.Tensor:
    """A non-causal T5 stack over x (B, L, D) with positions added. rnd
    rounds what the model's dtype stores: the weights, every matmul's and
    norm's output, the residual sums, the probabilities (identity for a
    float32 model); round_scores rounds the attention scores too (the
    plain attention; the fused kernel keeps them in f32)."""
    H, dk = sizes['num_heads'], sizes['d_kv']
    eps = sizes['layer_norm_epsilon']
    b, length, _ = x.shape
    x = rnd(x + rnd(sinusoid_table(sizes['d_model'], length).to(x.device)))

    def lin(h, key):
        return rnd(h @ rnd(w[key]).t())

    def norm(x, key):
        return rnd(w[key] * rnd(rms(x, torch.ones_like(w[key]), eps)))

    for i in range(layers):
        p = f'{name}.block.{i}.layer'
        h = norm(x, f'{p}.0.layer_norm.weight')
        q, k, v = (lin(h, f'{p}.0.SelfAttention.{n}.weight')
                   .view(b, length, H, dk).transpose(1, 2) for n in 'qkv')
        scores = q @ k.transpose(-1, -2)
        if round_scores:
            scores = rnd(scores)
        probs = rnd(torch.softmax(scores, dim=-1))
        att = rnd(probs @ v).transpose(1, 2).reshape(b, length, H * dk)
        x = rnd(x + lin(att, f'{p}.0.SelfAttention.o.weight'))
        h = norm(x, f'{p}.1.layer_norm.weight')
        g = rnd(rnd(gelu_tanh(lin(h, f'{p}.1.DenseReluDense.wi_0.weight')))
                * lin(h, f'{p}.1.DenseReluDense.wi_1.weight'))
        x = rnd(x + lin(g, f'{p}.1.DenseReluDense.wo.weight'))
    return norm(x, f'{name}.final_layer_norm.weight')


def encode(w: Weights, mel: torch.Tensor, sizes: dict,
           rnd: Callable = identity) -> torch.Tensor:
    """Log-mel (B, frames, mel_bins) -> encoder output (B, frames, D)."""
    x = rnd(rnd(mel) @ rnd(w['proj.weight']).t())
    return encoder_stack(w, 'encoder', x, sizes, sizes['num_layers'], rnd)


def memory(w: Weights, prev_tokens: torch.Tensor, sizes: dict,
           rnd: Callable = identity) -> torch.Tensor:
    """The previous segment's tokens (B, max_length) -> the memory rows
    (B, segmem_length, D). Its attention is the fused kernel's (f32
    scores) where the sequence is 512 or longer."""
    emb = rnd(w['decoder_embed_tokens.weight'][prev_tokens.long()])
    out = encoder_stack(w, 'segmem_encoder', emb, sizes,
                        sizes['segmem_num_layers'], rnd,
                        round_scores=prev_tokens.shape[1] < 512)
    return out[:, :sizes['segmem_length']]
