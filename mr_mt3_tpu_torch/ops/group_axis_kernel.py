"""The grouped int8 decode window (port of benchmarks/group_axis_kernel.py).

fused_decode_window_grouped decodes t_window greedy steps for G groups of 8
rows in one launch. For CUDA tensors it launches the hand-written CUDA
kernel fdw_grouped_launch of csrc/fused_decode_window.cu (it replaces the
TPU kernel benchmarks/group_axis_kernel.py::fused_decode_window_grouped);
for CPU tensors it runs fused_decode_window_grouped_reference, the plain
PyTorch version. Nothing falls back: a CUDA tensor launches the kernel or
raises.

On the TPU the group axis made each layer's weights stream once per (token,
layer) for all groups. The port's window already streams them once per step
for all of its up to 64 rows, so this form keeps the TPU kernel's function
and layouts, not its reason: the cache and cross K/V are group-major,
(L*G, H, 8, ...); the cache rows before the window are attended in the TPU
kernel's chunks; in-window rows are attended in bf16; the emitted K/V
scales are rounded to bf16 (and widened back to f32 in the cache); the
finished flags come from the window's tokens. It is int8 only, as the TPU
kernel is.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from mr_mt3_tpu_torch.models.config import MT3Config
from mr_mt3_tpu_torch.ops import fused_decode as fd
from mr_mt3_tpu_torch.ops.cuda_build import count_launch

GROUP_ROWS = 8       # rows per group (csrc: GROUP_ROWS)

# launches of the CUDA kernel; only the kernel path adds to it
LAUNCHES = {'fused': 0}


def regroup_cross_kv(cross: Dict[str, torch.Tensor], n_groups: int
                     ) -> Dict[str, torch.Tensor]:
    """(L, H, B, ...) cross K/V -> the group-major (L*G, H, 8, ...)."""

    def regroup(a):
        l, h, b = a.shape[:3]
        a = a.reshape((l, h, n_groups, b // n_groups) + a.shape[3:])
        a = a.movedim(2, 1)                  # (L, G, H, 8, ...)
        return a.reshape((l * n_groups, h, b // n_groups)
                         + a.shape[4:]).contiguous()

    return {k: regroup(v) for k, v in cross.items()}


def ungroup(a: torch.Tensor, n_groups: int) -> torch.Tensor:
    """(L*G, H, 8, ...) -> (L, H, G*8, ...), the inverse of regroup."""
    lg, h, rows = a.shape[:3]
    a = a.reshape((lg // n_groups, n_groups, h, rows) + a.shape[3:])
    return a.movedim(1, 2).reshape(
        (lg // n_groups, h, n_groups * rows) + a.shape[4:])


def init_fused_cache_grouped(cfg: MT3Config, n_groups: int, max_len: int,
                             device) -> Dict[str, torch.Tensor]:
    """Int8 self-K/V cache of the grouped window: kq/vq (L*G, H, 8, dk, P)
    and per-position f32 scales ks/vs (L*G, H, 8, P)."""
    lead = (cfg.num_decoder_layers * n_groups, cfg.num_heads, GROUP_ROWS)
    z = dict(device=device)
    return {'kq': torch.zeros(lead + (cfg.d_kv, max_len), dtype=torch.int8,
                              **z),
            'ks': torch.zeros(lead + (max_len,), **z),
            'vq': torch.zeros(lead + (cfg.d_kv, max_len), dtype=torch.int8,
                              **z),
            'vs': torch.zeros(lead + (max_len,), **z)}


def _groups(cfg: MT3Config, fp: fd.FusedParams, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor]) -> int:
    """The group count; raises on what the grouped window does not take."""
    if fd.fused_tier(fp) != 'fused':
        raise NotImplementedError(
            'fused_decode_window_grouped supports only int8 FusedParams '
            f'(got {fp.wqkv.dtype}), as the TPU kernel does')
    n_groups = cache['kq'].shape[0] // cfg.num_decoder_layers
    if tokens.shape[0] != n_groups * GROUP_ROWS:
        raise ValueError(f'tokens rows {tokens.shape[0]} != groups '
                         f'{n_groups} x {GROUP_ROWS}')
    return n_groups


@torch.no_grad()
def fused_decode_window_grouped_reference(
        cfg: MT3Config, fp: fd.FusedParams, pos_rows: torch.Tensor,
        tokens: torch.Tensor, finished: torch.Tensor, position: int,
        cache: Dict[str, torch.Tensor], cross: Dict[str, torch.Tensor],
        t_window: int, chunk: int, return_logits: bool = False):
    """Plain PyTorch version of the grouped kernel: the window's plain
    version on the layouts ungrouped, with the cache rows < position in
    chunks of `chunk` positions; its emitted rows in the grouped layout
    (T, L*G, H*8, ...), row (l*G + g, h*8 + r), the scales rounded to
    bf16. Returns (tokens_out (T, B) int32, finished_out (B,) int32, rows)
    [+ logits (T, B, vocab)], as fused_decode_window_reference."""
    n_groups = _groups(cfg, fp, tokens, cache)
    out = fd.fused_decode_window_reference(
        cfg, fp, pos_rows, tokens, finished, position,
        {k: ungroup(v, n_groups) for k, v in cache.items()},
        {k: ungroup(v, n_groups) for k, v in cross.items()}, t_window,
        return_logits=return_logits, chunk=chunk)
    T, L, H = t_window, cfg.num_decoder_layers, cfg.num_heads
    rows = {}
    for key, r in out[2].items():
        tail = r.shape[3:]
        r = r.reshape((T, L, H, n_groups, GROUP_ROWS) + tail).movedim(3, 2)
        r = r.reshape((T, L * n_groups, H * GROUP_ROWS) + tail)
        if key in ('ks', 'vs'):
            r = r.to(torch.bfloat16).float()
        rows[key] = r
    return (out[0], out[1], rows) + out[3:]


def fused_decode_window_grouped_cuda(
        cfg: MT3Config, fp: fd.FusedParams, pos_rows: torch.Tensor,
        tokens: torch.Tensor, finished: torch.Tensor, position: int,
        cache: Dict[str, torch.Tensor], cross: Dict[str, torch.Tensor],
        t_window: int, chunk: int, logits_out: torch.Tensor = None):
    """Launch the grouped kernel on the current stream; same arguments and
    outputs as fused_decode_window_grouped_reference (without logits). A
    given logits_out (B, vocab) f32 receives the last step's logits."""
    n_groups = _groups(cfg, fp, tokens, cache)
    out = fd.window_launch(cfg, fp, pos_rows, tokens, finished, position,
                           cache, cross, t_window, logits_out, chunk=chunk,
                           groups=n_groups)
    count_launch(LAUNCHES, 'fused')
    return out


def fused_decode_window_grouped(cfg: MT3Config, fp: fd.FusedParams, dp,
                                tokens: torch.Tensor,
                                finished: torch.Tensor, position: int,
                                cache: Dict[str, torch.Tensor],
                                cross: Dict[str, torch.Tensor],
                                t_window: int = 8, chunk_base: int = None
                                ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Decode t_window greedy steps for G groups of 8 rows in one launch.

    cache / cross in the group-major layout (init_fused_cache_grouped,
    regroup_cross_kv); tokens (G*8,) int, finished (G*8,) bool. The cache
    rows before the window are attended in chunks of min(chunk_base or
    chunk_base_for(Lenc), cache length) positions, which must divide the
    cache length. Returns (window_tokens (G*8, t_window) int32, finished
    (G*8,) bool, cache), the window's rows written into the cache in place.
    Raises FloatingPointError if a row that was not finished met NaN
    logits."""
    _groups(cfg, fp, tokens, cache)
    chunk = fd.cache_chunk(cache, cross, chunk_base)
    pos_rows = fd.window_pos_rows(dp, position, t_window)
    args = (cfg, fp, pos_rows, tokens, finished, position, cache, cross,
            t_window, chunk)
    if tokens.is_cuda:
        toks_w, _, rows = fused_decode_window_grouped_cuda(*args)
    elif tokens.device.type == 'cpu':
        toks_w, _, rows = fused_decode_window_grouped_reference(*args)
    else:
        raise ValueError(f'unsupported device {tokens.device}')
    if bool((toks_w >= cfg.vocab_size).any()):
        raise FloatingPointError(
            f'NaN logits in the grouped window at position {position}')
    fd.scatter_window_rows(cfg, cache, rows, position)
    toks = toks_w.t()
    # a row finishing in the window emits EOS once and pads after; rows
    # already finished emit only pads (group_axis_kernel.py:432)
    return toks, finished.bool() | (toks == cfg.eos_token_id).any(1), cache
