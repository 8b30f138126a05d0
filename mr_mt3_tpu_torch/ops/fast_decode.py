"""Greedy decode on stacked decoder parameters (port of
mr_mt3_tpu/ops/fast_decode.py).

Two loops:
  * greedy_loop_fast — a step-by-step KV-cache decode at the model's
    activation dtype, one decode_step_fast per step, run as the JAX
    package runs it on the device: the position is a 0-d int32 tensor on
    the device, the steps go in the reference's phases (DEFAULT_PHASES:
    the self-attention reads the cache up to the phase bound, the
    positions past the current one masked), and a DecodeRunner holds the
    loop's state in static buffers. On the card each block of
    _EXIT_CHECK_EVERY steps is a CUDA graph, captured the first time a
    decode reaches its phase and replayed after (graphs=False runs the
    same blocks uncaptured, a switch kept for comparison only); on the
    CPU the same blocks run eagerly. Tiers:
      'none'    the exact path, plain torch ops; it launches no kernel of
                its own and is the yardstick the other tiers are held
                against;
      'int8'    the same with each layer's gated-GELU feed-forward and the
                lm_head on int8 weights (ops/int8_matmul.py: one
                int8_gated_ff launch per layer, one int8_matmul per step);
      'int8_kv' the self and cross K/V in int8 with per-position scales,
                attention through ops/int8_attention.py (two
                int8_decode_attention launches per layer and step).
  * greedy_loop_fused (quantize='fused_bf16', 'fused' or 'fused_int4') —
    drives the whole-decoder window kernel
    (ops/fused_decode.py::fused_decode_window), FUSED_WINDOW greedy steps
    per launch, in the tier's mode (bf16, int8 or int4 weights and K/V).

Both return tokens (B, max_length + 1) with a leading start token;
finished rows emit pad and EOS finishes a row; rows that valid_mask marks
False (batch padding) start finished.

On a model axis (a model sharded by parallel/tensor.py::shard_model) the
exact tier stacks the rank's shards: its heads (caches sized by them), its
d_ff columns, its vocabulary rows and columns; each step sums the partial
products of o, cross-o and wo over the model group, looks its tokens up
in the vocab-parallel embedding and all-gathers the logits, so every model
rank takes the same greedy choice. CUDA graphs cannot capture gloo
collectives: over a gloo model group the step loops run their blocks
eagerly (use_graphs), as they do on the CPU.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from mr_mt3_tpu_torch.models.config import MT3Config
from mr_mt3_tpu_torch.models.mt3 import MT3, gelu_new
from mr_mt3_tpu_torch.ops import int8_attention, int8_matmul
from mr_mt3_tpu_torch.ops.cuda_build import count_launch
from mr_mt3_tpu_torch.ops.fused_decode import FUSED_TIERS
from mr_mt3_tpu_torch.parallel import tensor as tp_ops

# the step loops read the finished flags back to the host (a device sync)
# once every this many steps to stop early: a block of steps, one CUDA
# graph on the card
_EXIT_CHECK_EVERY = 8
# the JAX loop's phase bounds (mr_mt3_tpu/ops/fast_decode.py:283): the
# self-attention of a step below bound b reads the cache's first b
# positions
DEFAULT_PHASES = tuple(range(64, 1024, 64))
# greedy steps the step loops ran (eagerly or as replayed graphs), by tier
# ('module': ops/decode.py::_greedy_loop)
STEPS = {'none': 0, 'int8': 0, 'int8_kv': 0, 'module': 0}


class DecodeParams(NamedTuple):
    """Decoder weights stacked on a leading layer axis, (in, out) layout.

    With quantize='int8' the feed-forward weights are int8 codes with f32
    column scales (layers 'wi_0_q', 'wi_0_s', ...) and lm_head_q /
    lm_head_scale replace lm_head."""
    layers: Dict[str, torch.Tensor]  # name -> (L, ...) tensor
    token_embed: torch.Tensor        # (vocab, D)
    final_norm: torch.Tensor         # (D,) f32
    lm_head: torch.Tensor            # (D, vocab)
    pos_table: torch.Tensor          # (max_positions, D)
    lm_head_q: Any = None            # (D, vocab) int8 ('int8')
    lm_head_scale: Any = None        # (1, vocab) f32 ('int8')
    fused: Any = None                # FusedParams (the fused tiers)
    # the step loop's DecodeRunners (static buffers and captured graphs)
    # by decode shape, a dict on the card: dropped with the weights the
    # graphs read
    runners: Any = None
    # the model's parallel.tensor.ModelAxis where it is sharded: the
    # stacks hold this rank's shards
    tp: Any = None


@torch.no_grad()
def stack_decode_params(model: MT3, quantize: str = 'none') -> DecodeParams:
    """Stack the decoder blocks' weights along a leading layer axis.

    Every tensor lands on the model's device in its activation dtype. With
    a fused tier ('fused_bf16', 'fused', 'fused_int4') only the
    cross-attention K/V kernels are stacked (the window kernel holds the
    rest in FusedParams, packed for the tier). 'int8' quantizes wi_0, wi_1,
    wo and the lm_head per output column from the model's f32 parameters
    (not from the activation-dtype stack: two roundings would compound);
    'int8_kv' stacks as 'none' does (its K/V are quantized as they are
    made). A sharded model stacks its rank's shards, for 'none' only."""
    cfg = model.cfg
    dtype = cfg.activation_dtype
    blocks = list(model.decoder.block)
    if model.tp is not None and quantize != 'none':
        raise ValueError(f'quantize={quantize!r} is not supported with a '
                         'model axis > 1: the quantized tiers read whole '
                         'weight matrices')

    def stack(get):
        return torch.stack([get(b).weight.t() for b in blocks]).to(
            dtype).contiguous()

    layers = {'cross_k': stack(lambda b: b.cross_attn.k),
              'cross_v': stack(lambda b: b.cross_attn.v)}
    fused = lm_head_q = lm_head_scale = None
    lm_head = model.lm_head.weight.new_zeros((0,), dtype=dtype)
    if quantize in FUSED_TIERS:
        from mr_mt3_tpu_torch.ops.fused_decode import pack_fused_params
        fused = pack_fused_params(model, quantize)
    elif quantize in ('none', 'int8', 'int8_kv'):
        ff = (('wi_0', lambda b: b.ff.wi_0), ('wi_1', lambda b: b.ff.wi_1),
              ('wo', lambda b: b.ff.wo))
        for name, get in (('q', lambda b: b.self_attn.q),
                          ('k', lambda b: b.self_attn.k),
                          ('v', lambda b: b.self_attn.v),
                          ('o', lambda b: b.self_attn.o),
                          ('cross_q', lambda b: b.cross_attn.q),
                          ('cross_o', lambda b: b.cross_attn.o)) \
                + (() if quantize == 'int8' else ff):
            layers[name] = stack(get)
        for i, name in enumerate(('self_norm', 'cross_norm', 'ff_norm')):
            layers[name] = torch.stack(
                [b.norm(i).weight for b in blocks]).float()
        if quantize == 'int8':
            for name, get in ff:
                codes, scale = int8_matmul.quantize_columns(torch.stack(
                    [get(b).weight.float().t() for b in blocks]))
                layers[name + '_q'] = codes.contiguous()
                layers[name + '_s'] = scale.unsqueeze(-2).contiguous()
            lm_head_q, scale = int8_matmul.quantize_columns(
                model.lm_head.weight.float().t())
            lm_head_q = lm_head_q.contiguous()
            lm_head_scale = scale.unsqueeze(0).contiguous()
        else:
            lm_head = model.lm_head.weight.t().to(dtype).contiguous()
    else:
        raise ValueError(f'unknown quantize mode: {quantize!r}')
    return DecodeParams(
        layers=layers,
        token_embed=model.decoder_embed_tokens.weight.detach().to(dtype),
        final_norm=model.decoder.final_layer_norm.weight.detach().float(),
        lm_head=lm_head,
        pos_table=model.decoder.pos_table.to(dtype),
        lm_head_q=lm_head_q,
        lm_head_scale=lm_head_scale,
        fused=fused,
        runners={} if lm_head.is_cuda else None,
        tp=model.tp)


def decode_heads(cfg: MT3Config, dp: DecodeParams) -> int:
    """The heads dp's stacks hold (all, or the rank's on a model axis)."""
    return dp.layers['cross_k'].shape[-1] // cfg.d_kv


def _model_sum(dp: DecodeParams, x: torch.Tensor, sharded: bool
               ) -> torch.Tensor:
    """x summed over the model group where its product was sharded."""
    if dp.tp is None or not sharded:
        return x
    return tp_ops.reduce_from_model(x, dp.tp)


def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (weight * out.to(dtype)).to(dtype)


def precompute_cross_kv_stacked(dp: DecodeParams, cfg: MT3Config,
                                encoder_out: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V for all layers, 'bhdk' layout (L, B, H, Dk, Lenc)."""
    b, lenc, _ = encoder_out.shape
    enc = encoder_out.to(dp.token_embed.dtype)
    shape = (cfg.num_decoder_layers, b, decode_heads(cfg, dp), cfg.d_kv,
             lenc)
    k = torch.einsum('bsd,ldi->lbis', enc, dp.layers['cross_k'])
    v = torch.einsum('bsd,ldi->lbis', enc, dp.layers['cross_v'])
    return k.reshape(shape), v.reshape(shape)


def init_cache_stacked(cfg: MT3Config, batch: int, max_len: int,
                       device, dtype=None, heads: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, B, H, Dk, max_len) self K/V caches (H: heads, default all)."""
    dtype = dtype or cfg.activation_dtype
    shape = (cfg.num_decoder_layers, batch, heads or cfg.num_heads, cfg.d_kv,
             max_len)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_int8_cache_stacked(cfg: MT3Config, batch: int, max_len: int,
                            device) -> Dict[str, torch.Tensor]:
    """int8 self-K/V caches (L, B, H, Dk, P) with f32 scales per position
    (L, B, H, 1, P), P = max_len rounded up to a multiple of 4 (the
    positions past max_len are never written or read)."""
    align = int8_attention.POSITION_ALIGN
    p = -(-max_len // align) * align
    shape = (cfg.num_decoder_layers, batch, cfg.num_heads, cfg.d_kv, p)
    sshape = shape[:3] + (1, p)
    return {'kq': torch.zeros(shape, dtype=torch.int8, device=device),
            'ks': torch.zeros(sshape, dtype=torch.float32, device=device),
            'vq': torch.zeros(shape, dtype=torch.int8, device=device),
            'vs': torch.zeros(sshape, dtype=torch.float32, device=device)}


def quantize_cross_kv(cross_kv: Tuple[torch.Tensor, torch.Tensor]
                      ) -> Dict[str, Any]:
    """(L, B, H, Dk, Lenc) cross K/V in the activation dtype -> int8 codes
    and per-position scales, zero-padded to a multiple of 4 positions;
    'last' is the last real position (Lenc - 1), the one the attention
    stops at."""
    cross_k, cross_v = cross_kv
    lenc = cross_k.shape[-1]
    pad = -lenc % int8_attention.POSITION_ALIGN
    out: Dict[str, Any] = {'last': lenc - 1}
    for name, t in (('k', cross_k), ('v', cross_v)):
        codes, scale = int8_attention.quantize_kv_rows(t)
        out[name + 'q'] = torch.nn.functional.pad(codes, (0, pad)) \
            .contiguous()
        out[name + 's'] = torch.nn.functional.pad(scale, (0, pad)) \
            .contiguous()
    return out


def decode_step_fast(cfg: MT3Config, dp: DecodeParams, tokens: torch.Tensor,
                     position: torch.Tensor, cache, cross_kv, quantize: str,
                     bound: int) -> torch.Tensor:
    """One greedy step; tokens (B,) -> logits (B, vocab).

    position: a 0-d int32 tensor on the device, below bound, the phase
    bound (at most the cache length). Writes row `position` of the (L, B,
    H, Dk, P) caches in place (index_copy_) and attends over the first
    `bound` rows with the rows past `position` masked, as the JAX body
    does: -1e9 added in the activation dtype
    before the f32 softmax (exact zeros), or, in 'int8_kv', the kernel
    reading the position from device memory. quantize='int8' takes the
    feed-forward and the lm_head through the int8 kernels (dp stacked for
    'int8'); 'int8_kv' keeps the self and cross K/V in int8 (cache:
    init_int8_cache_stacked; cross_kv: quantize_cross_kv) and attends
    through int8_decode_attention. On a model axis the partial products
    are summed over the model group and the logits gathered."""
    eps = cfg.layer_norm_epsilon
    lay = dp.layers
    tp = dp.tp
    where = position.reshape(1)
    if tp is not None and tp.vocab:
        x = tp_ops.vocab_parallel_lookup(
            dp.token_embed, tokens, tp.index * dp.token_embed.shape[0],
            tp)[:, None, :]                                     # (B, 1, D)
    else:
        x = dp.token_embed.index_select(0, tokens)[:, None, :]
    x = x + dp.pos_table.index_select(0, where)
    if quantize == 'int8_kv':
        self_attention, cross_attention = (_int8_self_attention,
                                           _int8_cross_attention)
        mask = None
    else:
        self_attention, cross_attention = (_float_self_attention,
                                           _float_cross_attention)
        mask = torch.where(
            torch.arange(bound, device=x.device) <= position, 0.0,
            -1e9).to(x.dtype)
    at = _Where(position, where.long(), bound, mask)
    attn = tp is not None and tp.attention
    ff = tp is not None and tp.feed_forward
    for i in range(cfg.num_decoder_layers):
        h = _rms(x, lay['self_norm'][i], eps)
        x = x + _model_sum(dp, self_attention(cfg, lay, i, h, at, cache)
                           @ lay['o'][i], attn)
        h = _rms(x, lay['cross_norm'][i], eps)
        x = x + _model_sum(dp, cross_attention(cfg, lay, i, h, cross_kv)
                           @ lay['cross_o'][i], attn)
        x = x + _model_sum(dp, _feed_forward(
            lay, i, _rms(x, lay['ff_norm'][i], eps), quantize), ff)
    x = _rms(x, dp.final_norm, eps)
    if quantize == 'int8':
        return int8_matmul.int8_matmul(x[:, 0], dp.lm_head_q,
                                       dp.lm_head_scale)
    logits = (x @ dp.lm_head)[:, 0]
    if tp is not None and tp.vocab:
        return tp_ops.gather_from_model(logits, tp)
    return logits


class _Where(NamedTuple):
    """A step's position: the 0-d int32 tensor, its (1,) int64 index for
    index_copy_, the phase bound and the float tiers' (bound,) mask."""
    position: torch.Tensor
    index: torch.Tensor
    bound: int
    mask: Optional[torch.Tensor]


# Layer i's attention of h (B, 1, D) -> (B, 1, H * Dk), per K/V tier: the
# self-attention also writes row `position` of the cache.

def _attend(cfg: MT3Config, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, mask: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """q (B, 1, H * Dk); k/v (B, H, Dk, K); mask (K,) additive, in q's
    dtype -> (B, 1, H * Dk)."""
    batch, heads = q.shape[0], k.shape[1]
    q = q.reshape(batch, 1, heads, cfg.d_kv)
    scores = torch.einsum('bqhd,bhdk->bhqk', q, k)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum('bhqk,bhdk->bqhd', probs, v)
    return out.reshape(batch, 1, heads * cfg.d_kv)


def _float_self_attention(cfg, lay, i, h, at: _Where, cache):
    k_cache, v_cache = cache
    shape = (h.shape[0], k_cache.shape[2], cfg.d_kv, 1)
    k_cache[i].index_copy_(-1, at.index,
                           (h[:, 0] @ lay['k'][i]).reshape(shape))
    v_cache[i].index_copy_(-1, at.index,
                           (h[:, 0] @ lay['v'][i]).reshape(shape))
    return _attend(cfg, h @ lay['q'][i], k_cache[i, ..., :at.bound],
                   v_cache[i, ..., :at.bound], at.mask)


def _float_cross_attention(cfg, lay, i, h, cross_kv):
    cross_k, cross_v = cross_kv
    return _attend(cfg, h @ lay['cross_q'][i], cross_k[i], cross_v[i])


def _int8_self_attention(cfg, lay, i, h, at: _Where, cache):
    """The K/V row is quantized per position (quantize_kv_rows) as it is
    written."""
    shape = (h.shape[0], cfg.num_heads, cfg.d_kv)
    for name in ('k', 'v'):
        codes, scale = int8_attention.quantize_kv_rows(
            (h[:, 0] @ lay[name][i]).reshape(shape)[..., None])
        cache[name + 'q'][i].index_copy_(-1, at.index, codes)
        cache[name + 's'][i].index_copy_(-1, at.index, scale)
    return int8_attention.int8_decode_attention(
        (h[:, 0] @ lay['q'][i]).reshape(shape), cache['kq'][i],
        cache['ks'][i], cache['vq'][i], cache['vs'][i], at.position,
        at.bound)[:, None]


def _int8_cross_attention(cfg, lay, i, h, cross):
    shape = (h.shape[0], cfg.num_heads, cfg.d_kv)
    return int8_attention.int8_decode_attention(
        (h[:, 0] @ lay['cross_q'][i]).reshape(shape), cross['kq'][i],
        cross['ks'][i], cross['vq'][i], cross['vs'][i],
        cross['last'])[:, None]


def _feed_forward(lay: Dict[str, torch.Tensor], i: int, h: torch.Tensor,
                  quantize: str) -> torch.Tensor:
    """Layer i's gated-GELU feed-forward of h (B, 1, D): int8 weights in
    one int8_gated_ff launch ('int8'), else the activation-dtype matmuls."""
    if quantize == 'int8':
        return int8_matmul.int8_gated_ff(
            h[:, 0], lay['wi_0_q'][i], lay['wi_0_s'][i], lay['wi_1_q'][i],
            lay['wi_1_s'][i], lay['wo_q'][i], lay['wo_s'][i])[:, None, :]
    return (gelu_new(h @ lay['wi_0'][i]) * (h @ lay['wi_1'][i])) \
        @ lay['wo'][i]


def _start(cfg: MT3Config, batch: int, length: int, device,
           valid_mask: Optional[torch.Tensor]):
    tokens = torch.full((batch, length + 1), cfg.pad_token_id,
                        dtype=torch.int32, device=device)
    tokens[:, 0] = cfg.decoder_start_token_id
    finished = (torch.zeros(batch, dtype=torch.bool, device=device)
                if valid_mask is None
                else ~valid_mask.to(device=device, dtype=torch.bool))
    return tokens, finished


def phase_bounds(max_length: int, phases=DEFAULT_PHASES) -> List[int]:
    """The phases below max_length, then max_length (the JAX loops')."""
    return [p for p in sorted(phases) if p < max_length] + [max_length]


def run_phased_decode(bounds: List[int],
                      run_block: Callable[[int, int], None],
                      all_finished: Callable[[], bool],
                      every: int = _EXIT_CHECK_EVERY) -> int:
    """The JAX package's phase skeleton (mr_mt3_tpu/ops/fast_decode.py::
    run_phased_decode) on the host: positions 0 .. bounds[-1] - 1 in
    blocks of `every` steps (fewer only where a bound cuts one short),
    none crossing a bound. run_block(bound, steps) runs `steps` greedy
    steps of the phase that ends at `bound`; all_finished() is read before
    each block (the early exit, one sync a block). Returns the steps
    run."""
    i = 0
    for bound in bounds:
        while i < bound:
            if all_finished():
                return i
            steps = min(every, bound - i)
            run_block(bound, steps)
            i += steps
    return i


# the launch counters of the kernels a step runs, and the step counter:
# a captured block's counts are recorded at capture and added at each
# replay
_COUNTERS = (int8_matmul.LAUNCHES, int8_attention.LAUNCHES, STEPS)
# one block of any runner at a time, across the host threads of a mesh's
# replicas (infer/handler.py): a capture then runs alone, so the launches
# it records are its own, and no other thread's block lands in it. The
# blocks' launches are asynchronous and the exit checks lie outside it.
_BLOCK_LOCK = threading.Lock()


class DecodeRunner:
    """One greedy step loop's static buffers and captured blocks, for one
    decode shape (tier, batch, encoder length, max_length, dtype).

    The state the steps read and write lives in buffers allocated once:
    the tokens (B, max_length + 1) int32, the finished flags, the step
    index (a 0-d int32 tensor: the JAX loop's `i`), the caches and the
    cross K/V; reset() loads a decode's inputs into them, so nothing of
    one decode reaches the next. block(bound, steps) runs `steps` greedy
    steps of the phase that ends at `bound`: on the card, when graphs is
    on, as a CUDA graph captured the first time (after the same block run
    eagerly on the runner's side stream, the warm-up capture needs, which
    is also the decode's block) and replayed after; all graphs share one
    memory pool. Subclasses give the step (step(owner, bound)) and the
    phases; `owner` holds the weights (DecodeParams, or the model)."""

    tier = 'none'

    def __init__(self, cfg: MT3Config, batch: int, max_length: int,
                 device: torch.device, phases):
        self.cfg = cfg
        self.max_length = max_length
        self.device = torch.device(device)
        self.bounds = phase_bounds(max_length, phases)
        self.tokens = torch.empty((batch, max_length + 1), dtype=torch.int32,
                                  device=device)
        self.finished = torch.empty(batch, dtype=torch.bool, device=device)
        self.step_index = torch.zeros((), dtype=torch.int32, device=device)
        self.graphs: Dict[Tuple[int, int], Tuple[Any, list]] = {}
        self.pool = None
        self.stream = None
        self.capture_seconds = 0.0
        self.graph_allocated_bytes = 0
        self.graph_reserved_bytes = 0

    def step(self, owner, bound: int) -> None:
        raise NotImplementedError

    def reset_state(self, valid_mask: Optional[torch.Tensor]) -> None:
        """Tokens to [start, pad...], finished to ~valid_mask, step 0."""
        self.tokens.fill_(self.cfg.pad_token_id)
        self.tokens[:, 0] = self.cfg.decoder_start_token_id
        if valid_mask is None:
            self.finished.zero_()
        else:
            self.finished.copy_(~valid_mask.to(device=self.device,
                                               dtype=torch.bool))
        self.step_index.zero_()

    def current_tokens(self) -> torch.Tensor:
        """tokens[:, i] (B,) int32, i the step index on the device."""
        return self.tokens.index_select(1, self.step_index.reshape(1))[:, 0]

    def advance(self, logits: torch.Tensor) -> None:
        """The greedy choice of a step's logits: finished rows emit pad,
        EOS finishes a row; tokens[:, i + 1] written, i advanced, all on
        the device."""
        cfg = self.cfg
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(self.finished, cfg.pad_token_id, nxt)
        self.finished |= nxt == cfg.eos_token_id
        self.tokens.index_copy_(1, (self.step_index + 1).reshape(1).long(),
                                nxt[:, None])
        self.step_index += 1

    def _eager(self, owner, bound: int, steps: int) -> None:
        for _ in range(steps):
            self.step(owner, bound)
        count_launch(STEPS, self.tier, steps)

    def block(self, owner, bound: int, steps: int, graphs: bool) -> None:
        with _BLOCK_LOCK:
            if not graphs:
                self._eager(owner, bound, steps)
                return
            entry = self.graphs.get((bound, steps))
            if entry is None:
                self._warm_and_capture(owner, bound, steps)
                return
            graph, counts = entry
            graph.replay()
            for counter, recorded in zip(_COUNTERS, counts):
                for key, n in recorded.items():
                    count_launch(counter, key, n)

    def _warm_and_capture(self, owner, bound: int, steps: int) -> None:
        """The block eagerly on the side stream (the warm-up, a real
        block), then its capture; the capture's counts are recorded for
        the replays and taken back off the counters."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()
        # the feed-forward kernel's grid barrier words of the capture
        # stream, allocated (zeroed) before any capture
        int8_matmul._barrier(self.device, self.stream.cuda_stream)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self._eager(owner, bound, steps)
        current.wait_stream(self.stream)
        before = [dict(c) for c in _COUNTERS]
        # the graph's memory: the allocator's before and after, from an
        # empty cache (torch.cuda.graph empties it too)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        allocated = torch.cuda.memory_allocated(self.device)
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.monotonic()
        graph = torch.cuda.CUDAGraph()
        # thread_local: other replicas' threads may allocate and wait on
        # their own streams meanwhile (the global mode forbids it)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode='thread_local'):
            self._eager(owner, bound, steps)
        self.capture_seconds += time.monotonic() - t0
        self.graph_allocated_bytes += \
            torch.cuda.memory_allocated(self.device) - allocated
        self.graph_reserved_bytes += \
            torch.cuda.memory_reserved(self.device) - reserved
        recorded = []
        for counter, was in zip(_COUNTERS, before):
            recorded.append({k: counter[k] - was.get(k, 0) for k in counter})
            counter.update(was)
        self.graphs[(bound, steps)] = (graph, recorded)

    def blocks(self) -> List[Tuple[int, int]]:
        """Every (bound, steps) block a decode of max_length steps runs."""
        out = []
        run_phased_decode(self.bounds,
                          lambda bound, steps: out.append((bound, steps)),
                          lambda: False)
        return sorted(set(out))

    @torch.no_grad()
    def capture_all(self, owner) -> int:
        """Capture every block not captured yet (a server's prewarm, so
        that no request pays a capture): each is warmed up first at the
        last positions of its phase, on the buffers as the last decode
        left them (the next decode resets them). Returns the greedy steps
        the warm-ups ran."""
        ran = 0
        for bound, steps in self.blocks():
            with _BLOCK_LOCK:
                if (bound, steps) not in self.graphs:
                    self.step_index.fill_(bound - steps)
                    self._warm_and_capture(owner, bound, steps)
                    ran += steps
        return ran

    @torch.no_grad()
    def run(self, owner, graphs: bool) -> torch.Tensor:
        """The decode from the state reset() left: the phases' blocks up
        to max_length or until every row is finished; a copy of the
        tokens (the buffer is the next decode's)."""
        run_phased_decode(
            self.bounds,
            lambda bound, steps: self.block(owner, bound, steps, graphs),
            lambda: bool(self.finished.all()))
        return self.tokens.clone()

    def stats(self) -> Dict[str, Any]:
        return {'graphs': len(self.graphs),
                'capture_seconds': self.capture_seconds,
                'graph_allocated_bytes': self.graph_allocated_bytes,
                'graph_reserved_bytes': self.graph_reserved_bytes}


class FastRunner(DecodeRunner):
    """greedy_loop_fast's runner: decode_step_fast on the stacked
    parameters, the caches of the tier (init_cache_stacked or
    init_int8_cache_stacked) for max_length positions, the cross K/V (or
    its int8 codes and scales) for `lenc` encoder rows."""

    def __init__(self, cfg: MT3Config, quantize: str, batch: int, lenc: int,
                 max_length: int, device, dtype: torch.dtype,
                 heads: Optional[int] = None):
        super().__init__(cfg, batch, max_length, device, DEFAULT_PHASES)
        self.tier = quantize
        heads = heads or cfg.num_heads
        shape = (cfg.num_decoder_layers, batch, heads, cfg.d_kv, lenc)
        if quantize == 'int8_kv':
            self.cache = init_int8_cache_stacked(cfg, batch, max_length,
                                                 device)
            pad = -lenc % int8_attention.POSITION_ALIGN
            codes = shape[:-1] + (lenc + pad,)
            scales = shape[:3] + (1, lenc + pad)
            self.cross = {'last': lenc - 1}
            for name in ('k', 'v'):
                self.cross[name + 'q'] = torch.zeros(codes, dtype=torch.int8,
                                                     device=device)
                self.cross[name + 's'] = torch.zeros(
                    scales, dtype=torch.float32, device=device)
        else:
            self.cache = init_cache_stacked(cfg, batch, max_length, device,
                                            dtype, heads)
            self.cross = (torch.empty(shape, dtype=dtype, device=device),
                          torch.empty(shape, dtype=dtype, device=device))

    def reset(self, dp: DecodeParams, encoder_out: torch.Tensor,
              valid_mask: Optional[torch.Tensor]) -> None:
        cross_kv = precompute_cross_kv_stacked(dp, self.cfg, encoder_out)
        if self.tier == 'int8_kv':
            cross_kv = quantize_cross_kv(cross_kv)
            for key, t in cross_kv.items():
                if key != 'last':
                    self.cross[key].copy_(t)
            for t in self.cache.values():
                t.zero_()
        else:
            for dst, src in zip(self.cross, cross_kv):
                dst.copy_(src)
            for t in self.cache:
                t.zero_()
        self.reset_state(valid_mask)

    def step(self, dp: DecodeParams, bound: int) -> None:
        self.advance(decode_step_fast(
            self.cfg, dp, self.current_tokens(), self.step_index,
            self.cache, self.cross, quantize=self.tier, bound=bound))


def use_graphs(device: torch.device, graphs: Optional[bool],
               tp=None) -> bool:
    """Whether a step loop on `device` captures its blocks: on the card
    unless graphs=False (the eager comparison switch), never on the CPU
    (graphs=True there raises). On a model axis whose group is gloo never
    either (a capture cannot hold gloo's host-side collectives): the loop
    runs eagerly, which it says once on the card, and graphs=True
    raises."""
    if device.type != 'cuda':
        if graphs:
            raise ValueError('CUDA graphs need a CUDA device')
        return False
    if tp is not None and tp.backend() == 'gloo':
        if graphs:
            raise ValueError('CUDA graphs cannot capture the gloo '
                             'collectives of a model axis')
        if not tp.said_eager:
            print('tensor-parallel decode over gloo: CUDA graphs off, the '
                  'step loops run eagerly', flush=True)
            tp.said_eager = True
        return False
    return graphs is None or bool(graphs)


@torch.no_grad()
def greedy_loop_fast(cfg: MT3Config, dp: DecodeParams,
                     encoder_out: torch.Tensor, max_length: int,
                     quantize: str = 'none',
                     valid_mask: Optional[torch.Tensor] = None,
                     graphs: Optional[bool] = None) -> torch.Tensor:
    """Greedy decode; returns tokens (B, max_length + 1). dp must be
    stacked for the tier (stack_decode_params(model, quantize)). The step
    loop runs in the JAX loop's phases through a FastRunner: the one
    dp.runners keeps for this shape (on the card), else a new one. The
    caches hold max_length positions from the start; a step of the phase
    ending at b attends over the first b, the positions past the current
    one contributing exact zeros, as in the JAX loop's cache grown phase
    by phase. For 'int8_kv' the cross K/V is computed in the activation
    dtype first and then quantized, as JAX does. graphs: None captures
    and replays CUDA graphs on the card (the main path); False runs the
    same blocks eagerly there, for comparison only."""
    if quantize in FUSED_TIERS:
        return greedy_loop_fused(cfg, dp, encoder_out, max_length,
                                 valid_mask=valid_mask)
    if quantize not in ('none', 'int8', 'int8_kv'):
        raise ValueError(f'unknown quantize mode: {quantize!r}')
    if (dp.lm_head_q is not None) != (quantize == 'int8'):
        raise ValueError(f'the decode parameters were not stacked for '
                         f'quantize={quantize!r}')
    batch, lenc = encoder_out.shape[:2]
    dev = encoder_out.device
    graphs = use_graphs(dev, graphs, dp.tp)
    dtype = dp.token_embed.dtype
    key = (quantize, batch, lenc, max_length, dtype)
    runner = dp.runners.get(key) if dp.runners is not None else None
    if runner is None:
        runner = FastRunner(cfg, quantize, batch, lenc, max_length, dev,
                            dtype, decode_heads(cfg, dp))
        if dp.runners is not None:
            dp.runners[key] = runner
    runner.reset(dp, encoder_out, valid_mask)
    return runner.run(dp, graphs)


def capture_phases(dp: DecodeParams) -> Dict[str, Any]:
    """Capture every block of every runner dp holds (prewarm); returns
    the runners' summed stats and the warm-up steps it ran."""
    runners = list((dp.runners or {}).values())
    steps = sum(r.capture_all(dp) for r in runners)
    return merge_stats(runners, steps)


def merge_stats(runners, warmup_steps: int = 0) -> Dict[str, Any]:
    out = {'runners': len(runners), 'graphs': 0, 'capture_seconds': 0.0,
           'graph_allocated_bytes': 0, 'graph_reserved_bytes': 0,
           'capture_warmup_steps': warmup_steps}
    for r in runners:
        for key, value in r.stats().items():
            out[key] += value
    return out


@torch.no_grad()
def greedy_loop_fused(cfg: MT3Config, dp: DecodeParams,
                      encoder_out: torch.Tensor, max_length: int,
                      valid_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Greedy decode through the whole-decoder window kernel.

    Each fused_decode_window call decodes t_win steps (embed -> layers ->
    lm_head -> argmax in one launch). The window length is a token rule,
    not a memory rule: it decides which attention rows take the cache's
    numerics (rows of earlier windows: a bf16-rounded q in bf16 mode,
    int8 q and codes in the integer modes) and which the window's own
    (rows of the current window: f32 q, bf16 rows). The tier is read from
    dp.fused; the cross K/V and the cache take its mode. The self-K/V
    cache is
    allocated once for the window-aligned decode budget; the kernel reads
    only rows before the window. Stops early once every row is finished,
    checked on the host once per window."""
    from mr_mt3_tpu_torch.ops.fused_decode import (
        FUSED_MAX_BATCH,
        FUSED_WINDOW,
        fused_decode_window,
        fused_tier,
        init_fused_cache,
        precompute_cross_kv_fused,
    )
    batch = encoder_out.shape[0]
    if batch > FUSED_MAX_BATCH:
        raise ValueError(f'fused decode supports at most {FUSED_MAX_BATCH} '
                         f'rows per call (got {batch})')
    dev = encoder_out.device
    t_win = min(FUSED_WINDOW, max(8, -(-max_length // 8) * 8))
    ml_eff = -(-max_length // t_win) * t_win
    cross = precompute_cross_kv_fused(dp, cfg, encoder_out)
    cache = init_fused_cache(cfg, batch, ml_eff, dev, fused_tier(dp.fused))
    tokens, finished = _start(cfg, batch, ml_eff, dev, valid_mask)
    for i in range(0, ml_eff, t_win):
        toks_w, finished, cache = fused_decode_window(
            cfg, dp.fused, dp, tokens[:, i], finished, i, cache, cross,
            t_window=t_win)
        tokens[:, i + 1:i + 1 + t_win] = toks_w
        if bool(finished.all()):
            break
    return tokens[:, :max_length + 1]
