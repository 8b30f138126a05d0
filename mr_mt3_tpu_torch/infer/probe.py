"""Quantized-decode safety probe (port of mr_mt3_tpu/infer/probe.py).

The zero-flip evidence of the integer window tiers is from the overfit
parity model; a real checkpoint with near-uniform logits can flip tokens
silently. This probe decodes a deterministic music-like batch through a
handler's quantized path AND an exact twin and counts token flips, so the
server can demote its tier ('fused_int4' -> 'fused' -> 'fused_bf16' ->
'none'; 'int8' and 'int8_kv' -> 'none') before it trusts the quantized numerics on the weights it serves.
Names, info-dict keys and printed wording are the JAX package's, so
/healthz reads the same on both servers. For an 'encoder_append' model
the teacher-forced margins rebuild the carried memory from the decoded
tokens, and a contiguous handler's probe rows form one chain.
"""

from __future__ import annotations

import numpy as np
import torch


def probe_audio(num_segments: int = 2, sample_rate: int = 16000
                ) -> np.ndarray:
    """A chord + percussion-ish bursts, so logits are exercised on
    music-like (not silent) input. Sized 64 samples short of an exact hop
    multiple: the frontend pads a full extra hop when the length divides
    the hop (reference pad_end framing), so an exact multiple would gain an
    all-padding segment."""
    n = num_segments * 256 * 128 - 64
    t = np.arange(n, dtype=np.float32) / sample_rate
    audio = (0.2 * np.sin(2 * np.pi * 261.63 * t)      # C4
             + 0.2 * np.sin(2 * np.pi * 329.63 * t)    # E4
             + 0.15 * np.sin(2 * np.pi * 392.0 * t))   # G4
    burst = (np.arange(n) % (sample_rate // 2)) < 800  # 2 Hz clicks
    audio = audio + 0.3 * burst * np.sin(2 * np.pi * 1200 * t)
    return audio.astype(np.float32)


def probe_mel(handler, num_segments: int = 2) -> torch.Tensor:
    """probe_audio through the handler's frontend -> mel
    (num_segments, 256, mel_bins) on the handler's device."""
    segments, _, valid = handler._audio_to_segments(
        probe_audio(num_segments, handler.SAMPLE_RATE))
    return handler._compute_mel(segments, valid)


# Ladder probes run at a SHORT max_length: losing tiers flip within the
# first tokens on random or near-uniform weights, so a short flip count
# rejects them as well as a full one. The short probe alone is not the
# whole guard: quantized-KV attention error grows with the cached
# positions, so once a quantized tier probes clean at the short length,
# resolve_auto_quantize runs ONE full-length confirm probe on it.
PROBE_MAX_LENGTH = 256


def _probe_twin(handler, quantize: str, max_length: int):
    """A handler sharing `handler`'s model, device and decode config
    (contiguous mode, segment bucket, memory chain and format), with the
    given quantize tier and (short) decode length. At the handler's own
    tier it shares the handler's decode parameters too, and with them the
    step loop's runners and graphs: the full-length confirm then captures
    the graphs the server replays."""
    from mr_mt3_tpu_torch.infer.handler import InferenceHandler
    twin = InferenceHandler(
        model=handler.model, mel_norm=handler.mel_norm,
        contiguous_inference=handler.contiguous_inference,
        batch_size=handler.batch_size, max_length=max_length,
        segment_bucket=handler.segment_bucket, quantize=quantize,
        device=handler.device, segmem_chain=handler.segmem_chain,
        segmem_memory_format=handler.segmem_memory_format)
    twin.spectrogram_config = handler.spectrogram_config
    if quantize == handler.quantize and \
            handler.cfg.segmem_variant != 'decoder_prepend':
        twin.replicas[0].dp = handler._decode_params()
    return twin


def quantize_probe(handler, max_length: int = None, classify: bool = False):
    """Decode the probe batch through the handler's quantized path AND an
    exact twin at the same length; return (flipped_tokens, total_tokens),
    or, with classify=True, a dict {flips, total} merged with
    classify_flips()'s readout (material vs benign first flips).
    max_length=None means the short ladder length
    (min(handler.max_length, PROBE_MAX_LENGTH)); resolve_auto_quantize
    passes handler.max_length for the winner's full-length confirm.

    The exact-side tokens are cached on the handler per decode shape: they
    depend only on the weights and config, which do not change across the
    demotion ladder's re-probes."""
    max_length = (min(handler.max_length, PROBE_MAX_LENGTH)
                  if max_length is None else max_length)
    mel = probe_mel(handler)
    quant = _probe_twin(handler, handler.quantize,
                        max_length)._decode_all(mel)
    cache = getattr(handler, '_probe_exact_tokens', None)
    if cache is None:
        cache = handler._probe_exact_tokens = {}
    exact = cache.get(quant.shape)
    if exact is None:
        exact = _probe_twin(handler, 'none', max_length)._decode_all(mel)
        cache[quant.shape] = exact
    flips, total = int(np.sum(quant != exact)), int(quant.size)
    if not classify:
        return flips, total
    out = {'flips': flips, 'total': total}
    if flips:
        try:
            out.update(classify_flips(handler, quant, exact, mel))
        except Exception as e:
            # classification is a refinement, not the guard: without it
            # the caller treats every flip as material (strict fallback)
            out['classify_error'] = repr(e)[:200]
    return out


@torch.no_grad()
def _teacher_forced_margins(handler, mel, tokens, dtype: str = None):
    """Top1-minus-top2 margins + greedy argmax of a teacher-forced forward
    over the exact decode's own tokens (one parallel forward with the
    greedy loop's conditioning). For an 'encoder_append' model the rows
    are one chain: row 0 remembers the seed, row r the tokens of row r-1
    in the handler's memory format. dtype overrides the model's compute
    dtype: a twin model with the same weights under cfg.replace(dtype=...)
    calibrates the numeric noise. Returns (margins (N, L) np.float32,
    greedy (N, L) np, valid (N, L) bool); valid marks positions up to each
    row's first EOS."""
    cfg = handler.cfg
    model = handler.model
    if dtype is not None and dtype != cfg.dtype:
        from mr_mt3_tpu_torch.models import MT3
        twin = MT3(cfg.replace(dtype=dtype))
        twin.load_state_dict(model.state_dict())
        model = twin.to(handler.device).eval()
    tokens = np.array(tokens)                     # (N, L+1), col 0 start id
    dev = handler.device
    prev = None
    if cfg.segmem_variant == 'encoder_append':
        from mr_mt3_tpu_torch.ops.decode import initial_segmem_tokens
        L = tokens.shape[1] - 1
        seed = initial_segmem_tokens(cfg, 1, L, codec=handler.codec,
                                     vocab=handler.vocab).numpy()
        if handler.segmem_memory_format == 'train_aligned':
            carried = tokens[:-1, 1:L + 1]
        else:
            carried = tokens[:-1, :L]
        prev = torch.as_tensor(np.concatenate([seed, carried], axis=0),
                               dtype=torch.long, device=dev)
    ids = torch.as_tensor(tokens[:, :-1], dtype=torch.long, device=dev)
    logits = model(torch.as_tensor(mel, device=dev), ids, targets_prev=prev)
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1]).cpu().numpy()   # (N, L)
    greedy = logits.argmax(-1).cpu().numpy()
    targets = tokens[:, 1:]
    L = targets.shape[1]
    eos_pos = np.where((targets == cfg.eos_token_id).any(axis=1),
                       (targets == cfg.eos_token_id).argmax(axis=1), L - 1)
    valid = np.arange(L)[None, :] <= eos_pos[:, None]
    return margins, greedy, valid


# Material-flip calibration: a probe flip is MATERIAL when the exact
# path's own margin at the first divergence exceeds what numeric noise
# can move. The noise scale is measured per checkpoint (model-dtype vs f32
# margin delta on the same teacher-forced forward); the safety factor
# covers the quantized side's independent same-scale reassociation noise,
# and the floor guards degenerate all-zero deltas (f32 models).
MATERIAL_NOISE_SAFETY = 4.0
MATERIAL_MARGIN_FLOOR = 1e-3


def classify_flips(handler, quant, exact, mel) -> dict:
    """Classify free-running probe divergences by mechanism: a row whose
    first flip sits at a margin numeric noise can cross is BENIGN (two
    valid greedy samples of the same near-tie distribution); one whose
    margin exceeds the measured noise ceiling is MATERIAL (the quantized
    path overrode a confident decision). Only each row's FIRST flip is
    classified: past it the two paths condition on different prefixes.
    A contiguous segment-memory handler's probe rows form ONE chain, so
    the rows after its first diverged row are incomparable and counted as
    downstream_rows.

    Returns {material_rows, benign_rows, downstream_rows, rows,
    material_margin, margin_noise, first_flip_margins}."""
    quant = np.asarray(quant)
    exact = np.asarray(exact)
    margins, _, valid = _teacher_forced_margins(handler, mel, exact)
    margins_f32, _, _ = _teacher_forced_margins(handler, mel, exact,
                                                dtype='float32')
    noise = float(np.abs(margins - margins_f32)[valid].max())
    tau = max(MATERIAL_NOISE_SAFETY * noise, MATERIAL_MARGIN_FLOOR)
    diff = quant != exact                          # (N, L+1)
    chained = bool(handler.contiguous_inference
                   and handler.cfg.segmem_variant == 'encoder_append')
    out = {'material_rows': 0, 'benign_rows': 0, 'downstream_rows': 0,
           'rows': int(quant.shape[0]),
           'material_margin': round(tau, 5),
           'margin_noise': round(noise, 6),
           'first_flip_margins': []}
    upstream_diverged = False
    for r in range(quant.shape[0]):
        if not diff[r].any():
            continue
        if chained and upstream_diverged:
            out['downstream_rows'] += 1
            continue
        p = int(diff[r].argmax())                  # token coords; col 0 seed
        m = float(margins[r, p - 1]) if p >= 1 else float('inf')
        out['first_flip_margins'].append(round(m, 4))
        if m > tau:
            out['material_rows'] += 1
        else:
            out['benign_rows'] += 1
        upstream_diverged = chained
    return out


def margin_stats(handler, max_length: int = None) -> dict:
    """Top1-minus-top2 logit margins of the EXACT decode on the probe
    batch, the mechanism behind tier demotions (a decoded token flips when
    its margin is within the fused tiers' numeric noise). Rescoring is
    teacher-forced on the exact decode's own tokens; only positions up to
    each row's EOS count. Returns {margin_min, margin_p1, margin_p5,
    margin_median, tokens, teacher_forced_agreement}, or {'error': ...}
    for a decoder_prepend model (no teacher-forced surface for its
    decode)."""
    if handler.cfg.segmem_variant == 'decoder_prepend':
        return {'error': 'decoder_prepend probe margins unsupported'}
    max_length = (min(handler.max_length, PROBE_MAX_LENGTH)
                  if max_length is None else max_length)
    mel = probe_mel(handler)
    cache = getattr(handler, '_probe_exact_tokens', {})
    exact = None
    for toks in cache.values():
        if toks.shape[1] == max_length + 1:
            exact = toks
    if exact is None:
        exact = _probe_twin(handler, 'none', max_length)._decode_all(mel)
    tokens = np.asarray(exact)                    # (N, L+1), col 0 start id
    margins, greedy, valid = _teacher_forced_margins(handler, mel, tokens)
    m = margins[valid]
    agree = float((greedy[valid] == tokens[:, 1:][valid]).mean())
    return {
        'margin_min': round(float(m.min()), 4),
        'margin_p1': round(float(np.quantile(m, 0.01)), 4),
        'margin_p5': round(float(np.quantile(m, 0.05)), 4),
        'margin_median': round(float(np.quantile(m, 0.5)), 4),
        'tokens': int(m.size),
        'teacher_forced_agreement': round(agree, 4),
    }


# demotion ladder, top to bottom: int4 window kernel (the serving
# default) -> int8 window kernel -> bf16 window kernel (exact-numerics
# class) -> the exact path. Every other quantized mode falls to 'none'.
_NEXT_TIER = {'fused_int4': 'fused', 'fused': 'fused_bf16'}

# Every per-probe info key resolve_auto_quantize can record; demotion
# paths (here and serve.prepare_handler's prewarm demotions) clear them so
# stale counts are never attributed to a tier that didn't measure them.
PROBE_INFO_KEYS = ('probe_flips', 'probe_tokens', 'probe_tier',
                   'probe_material_rows', 'probe_benign_rows',
                   'probe_downstream_rows', 'material_margin',
                   'margin_noise', 'first_flip_margins', 'classify_error',
                   'confirm_flips', 'confirm_tokens',
                   'confirm_material_rows', 'probe_error')


def demotes_on_error(handler) -> bool:
    """Whether a probe or prewarm exception may demote the handler's tier.
    Only on the CPU, where every quantized tier runs its kernels' plain
    versions, as the JAX package demotes on any failure. On the card a
    tier runs its CUDA kernels, and an exception is a fault of the kernel (its build,
    launch or operand checks) or of the port: it propagates, so the
    server never hides a broken kernel behind a lower tier."""
    return handler.device.type != 'cuda'


def resolve_auto_quantize(handler, verbose: bool = True,
                          probe_fn=None) -> dict:
    """Probe-guard a handler whose quantize tier is set: a MATERIAL token
    flip demotes it one tier ('fused_int4' -> 'fused' -> 'fused_bf16' ->
    'none'; other modes -> 'none') and re-probes until a tier survives
    (or 'none' is reached). A tier that survives the short probe is
    confirmed with one probe at the FULL serving length; a confirm
    material flip demotes the same way. A probe failure demotes too where
    demotes_on_error(handler) allows it, and propagates elsewhere.

    Flips are classified with classify_flips, and only material ones
    demote; whenever classification is missing (a probe_fn returning
    (flips, total), or a classification error) every flip counts as
    material.

    Returns an info dict {quantize, probe_flips, probe_tokens,
    probe_tier[, probe_material_rows, probe_benign_rows,
    probe_downstream_rows, material_margin, margin_noise,
    first_flip_margins, confirm_flips, confirm_tokens,
    confirm_material_rows, probe_error, demotions]}; the counts are those
    of the LAST probe that ran, and probe_tier names the tier they
    measured. Counts are cleared before each probe attempt, so a tier
    whose probe raises never inherits an earlier tier's counts.

    probe_fn overrides the probe: called as probe_fn(handler) for short
    probes and probe_fn(handler, max_length=N) for the confirm; if it
    accepts `classify` (or **kw) it is asked for the classified dict."""
    import inspect

    info = {'quantize': handler.quantize}
    if handler.quantize == 'none':
        return info

    def accepts_classify(fn):
        try:
            params = inspect.signature(fn).parameters
        except (TypeError, ValueError):
            return False
        return ('classify' in params
                or any(p.kind == p.VAR_KEYWORD for p in params.values()))

    def run_probe(**kw):
        """One probe call -> (flips, total, material_or_None, extras).
        material is None when no classification is available."""
        fn = probe_fn or quantize_probe
        if accepts_classify(fn):
            try:
                return _unpack(fn(handler, classify=True, **kw))
            except TypeError:
                # a **kw wrapper in front of a classify-unaware probe:
                # retry plain (the signature mismatch raises before any
                # decode runs)
                pass
        return _unpack(fn(handler, **kw))

    def _unpack(res):
        if isinstance(res, dict):
            extras = {k: v for k, v in res.items()
                      if k not in ('flips', 'total')}
            material = (res.get('material_rows')
                        if 'material_rows' in res else None)
            if res['flips'] and material is None:
                material = res['flips']   # classification failed: strict
            return res['flips'], res['total'], material, extras
        flips, total = res
        return flips, total, None, {}

    def demote(reason: str, to: str = None):
        nxt = to if to is not None else _NEXT_TIER.get(handler.quantize,
                                                       'none')
        if verbose:
            print(f'quantize={handler.quantize!r} demoted to {nxt!r}: '
                  f'{reason}')
        handler.quantize = nxt
        handler._invalidate_compiled()
        info.setdefault('demotions', []).append(reason)

    if handler.cfg.segmem_variant == 'decoder_prepend':
        # no window-kernel path for the decoder-prepend prefill: straight
        # to exact numerics, skipping the ladder
        demote('decoder_prepend models have no quantized decode path',
               to='none')
        info['quantize'] = 'none'
        return info
    while handler.quantize != 'none':
        # stale-evidence guard: drop the previous tier's counts before
        # probing, so an exception path can't leave them attributed to a
        # tier that never measured them
        for k in PROBE_INFO_KEYS:
            info.pop(k, None)
        try:
            flips, total, material, extras = run_probe()
        except Exception as e:
            if not demotes_on_error(handler):
                raise
            info['probe_error'] = repr(e)[:200]
            demote(f'probe failed ({e!r})')
            continue
        info['probe_flips'] = flips
        info['probe_tokens'] = total
        info['probe_tier'] = handler.quantize
        for k in ('material_rows', 'benign_rows', 'downstream_rows'):
            if k in extras:
                info[f'probe_{k}'] = extras[k]
        for k in ('material_margin', 'margin_noise', 'first_flip_margins',
                  'classify_error'):
            if k in extras:
                info[k] = extras[k]
        effective = material if material is not None else flips
        if effective:
            if material is not None and material != flips:
                demote(f'{material} material first-flip(s) '
                       f'(margin > {extras.get("material_margin")}) among '
                       f'{flips}/{total} flipped probe tokens vs exact bf16')
            else:
                demote(f'{flips}/{total} probe tokens flipped vs exact bf16')
            continue
        if flips and verbose:
            print(f'quantize={handler.quantize!r}: {flips}/{total} probe '
                  f'flips, all benign (first-flip margins '
                  f'{extras.get("first_flip_margins")} <= noise ceiling '
                  f'{extras.get("material_margin")}) — tier kept')
        if handler.max_length > PROBE_MAX_LENGTH:
            try:
                cflips, ctotal, cmaterial, cextras = run_probe(
                    max_length=handler.max_length)
            except Exception as e:
                if not demotes_on_error(handler):
                    raise
                info['probe_error'] = repr(e)[:200]
                demote(f'full-length confirm failed ({e!r})')
                continue
            info['confirm_flips'] = cflips
            info['confirm_tokens'] = ctotal
            if 'material_rows' in cextras:
                info['confirm_material_rows'] = cextras['material_rows']
            ceffective = cmaterial if cmaterial is not None else cflips
            if ceffective:
                if cmaterial is not None and cmaterial != cflips:
                    demote(f'{cmaterial} material first-flip(s) among '
                           f'{cflips}/{ctotal} flips at full length '
                           f'{handler.max_length}')
                else:
                    demote(f'{cflips}/{ctotal} tokens flipped vs exact '
                           f'bf16 at full length {handler.max_length}')
                continue
        break
    info['quantize'] = handler.quantize
    return info
