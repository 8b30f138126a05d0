"""The benchmark's yardstick: the card's published peaks, the least time of
a kernel's work from its shapes, and the model FLOPs of a decoded segment.

Every function here takes shapes and returns numbers; none reads the
program. The bound of a kernel is the larger of its bytes over the HBM
bandwidth and its operations over the tensor-core peak, counting each input
byte once and each output byte once, whatever the kernel reads again.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published dense peaks (data sheet, 700 W).
PEAKS = {
    'hbm_bytes_per_s': 3.35e12,
    'bf16_flops': 989e12,
    'int8_ops': 1979e12,
    'fp8_flops': 1979e12,
    'tf32_flops': 495e12,
    'fp32_flops': 67e12,
}

# bytes a weight code takes in each window tier
TIER_WIDTH = {'fused_bf16': 2, 'fused': 1, 'fused_int4': 0.5}


def decoder_sizes(sizes: dict):
    """(L, D, inner, F, V, H, dk) of a configuration's decoder."""
    return (sizes['num_decoder_layers'], sizes['d_model'],
            sizes['num_heads'] * sizes['d_kv'], sizes['d_ff'],
            sizes['vocab_size'], sizes['num_heads'], sizes['d_kv'])


def decoder_macs(sizes: dict) -> int:
    """Multiply-adds of the decoder's projections and lm_head for one row
    and one step: q|k|v, o, the cross q and o, the gated feed-forward."""
    L, D, inner, F, V, _, _ = decoder_sizes(sizes)
    per_layer = (D * 3 * inner + inner * D + D * inner + inner * D
                 + D * 2 * F + F * D)
    return L * per_layer + D * V


def decoder_bytes(sizes: dict, tier: str) -> float:
    """Bytes of the decoder's weights, lm_head, norms and the integer
    tiers' f32 column scales, as the window kernel reads them."""
    L, D, inner, F, V, _, _ = decoder_sizes(sizes)
    width = TIER_WIDTH[tier]
    weights = width * decoder_macs(sizes) + 4 * (L * 3 * D + D)
    if tier != 'fused_bf16':
        weights += 4 * (L * (3 * inner + D + inner + D + 2 * F + D) + V)
    return weights


def window_bound_s(sizes: dict, batch: int, pos0: int, lenc: int,
                   t_window: int, tier: str):
    """Least time of one launch of the greedy window kernel: t_window
    steps of `batch` rows from position pos0 over an encoder of lenc rows.
    Bytes: the weights, the embedding and position rows the window uses,
    the K/V codes and scales of the cache rows < pos0 and of the encoder,
    the tokens and flags; written, the emitted K/V rows and the tokens.
    Operations: the projections at the bf16 peak, the attention dots at
    the bf16 peak (bf16 tier) or the int8 peak (integer tiers). Returns
    (seconds, 'bytes' or 'operations')."""
    L, D, _, _, _, H, dk = decoder_sizes(sizes)
    scaled = tier != 'fused_bf16'
    width = TIER_WIDTH[tier]
    kv_pos = L * H * batch * (lenc + pos0)
    read = (decoder_bytes(sizes, tier) + 2 * t_window * batch * D
            + 4 * t_window * D
            + 2 * kv_pos * (width * dk + (4 if scaled else 0)) + 8 * batch)
    rows = 2 * t_window * L * H * batch
    written = 4 * t_window * batch + 4 * batch + (
        rows * (dk + 4) if scaled else rows * 2 * dk)
    proj = t_window * 2 * batch * decoder_macs(sizes)
    attn = sum(L * batch * H * 2 * 2 * dk * (pos0 + t + 1 + lenc)
               for t in range(t_window))
    t_bytes = (read + written) / PEAKS['hbm_bytes_per_s']
    t_ops = proj / PEAKS['bf16_flops'] + attn / (
        PEAKS['int8_ops'] if scaled else PEAKS['bf16_flops'])
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def attention_columns(lq: int, kv_valid: int, causal: bool) -> int:
    """The key columns the lq query rows see in all."""
    if not causal:
        return lq * kv_valid
    return sum(min(kv_valid, i + 1) for i in range(lq))


def attention_bound_s(b: int, lq: int, kv_valid: int, h: int, d: int,
                      causal: bool):
    """Least time of one attention forward: q, the kv_valid K/V rows and
    the output moved once in bf16, against the q.k and p.v products over
    the columns each row sees at the bf16 peak. Returns (seconds,
    'bytes' or 'operations')."""
    flops = 2 * 2 * b * h * d * attention_columns(lq, kv_valid, causal)
    nbytes = 2 * b * h * d * (2 * lq + 2 * kv_valid)
    t_bytes = nbytes / PEAKS['hbm_bytes_per_s']
    t_ops = flops / PEAKS['bf16_flops']
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def stack_flops(sizes: dict, layers: int, length: int,
                kv_length: int = None) -> float:
    """FLOPs of an encoder stack of `layers` blocks over `length` rows
    (self-attention over kv_length keys, default all): q|k|v|o, the
    scores and values, the gated feed-forward."""
    D, inner, F = sizes['d_model'], sizes['num_heads'] * sizes['d_kv'], \
        sizes['d_ff']
    kv = length if kv_length is None else kv_length
    proj = length * (4 * D * inner + 3 * D * F)
    attn = 2 * length * kv * inner
    return 2.0 * layers * (proj + attn)


def segment_decode_flops(sizes: dict, steps: int, lenc: int) -> float:
    """FLOPs of one real segment's greedy decode of `steps` steps over an
    encoder of lenc rows: the projections and lm_head each row-step,
    the self-attention over the live cache (t + 1 positions at step t),
    the cross-attention over lenc rows, and the cross K/V projection of
    the encoder once."""
    L, D, inner, _, _, H, dk = decoder_sizes(sizes)
    macs = steps * decoder_macs(sizes)
    macs += L * H * dk * 2 * (steps * (steps + 1) // 2 + steps * lenc)
    macs += L * lenc * D * 2 * inner
    return 2.0 * macs


def segment_flops(sizes: dict, steps: int, memory: bool) -> float:
    """FLOPs of one real segment through the model: the input projection
    and the audio encoder over its frames, the memory encoder over the
    previous segment's tokens (segment-memory models), and the decode."""
    frames = sizes['frames']
    enc = 2.0 * frames * sizes['mel_bins'] * sizes['d_model']
    enc += stack_flops(sizes, sizes['num_layers'], frames)
    lenc = frames
    if memory:
        enc += stack_flops(sizes, sizes['segmem_num_layers'],
                           sizes['max_length'])
        lenc += sizes['segmem_length']
    return enc + segment_decode_flops(sizes, steps, lenc)
