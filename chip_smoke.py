#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (mr_mt3_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. environment: card name and power limit, torch / CUDA / nvcc versions;
  2. build: every kernel of the main paths from csrc/ (nvcc, one process
     per source, started together): fused_decode_window and
     fused_attention_fwd;
  3. window kernel against its plain PyTorch version on the card at full
     width (MT3Config(), seeded weights and encoder states, Lenc 256), in
     each mode (fused_bf16, fused = int8, fused_int4):
     B in {8, 64} x pos0 in {0, 32, 992}, and B in {8, 64}, pos0 992 at
     the segment-memory model's Lenc 320, the cache rows < pos0 decoded
     by the kernel itself; tokens equal up to a first divergence that is
     only allowed where the plain version scores the two tokens nearly
     alike; bf16 K/V rows, or integer K/V codes and their scales, and
     last-step logits within each mode's bounds (BOUNDS); in the integer
     modes the same bounds must also fail the kernel against a control,
     a plain version without the int8 requantization of q and the
     probabilities; CUDA-event timings (median) beside the
     bytes/operations bound;
  4. fused_attention_fwd against its plain version at the segment-memory
     path's shapes (ATTN_CASES: the memory encoder at B 8 and 64, the
     probe's causal decoder and 1024 x 320 cross attention, the parity
     model's head width 24), called as the model calls it (fused_attention
     on the unpadded K/V: its padding and kv_valid included) and compared
     with the plain version on the padded K/V, within ATTN_BOUNDS, with the
     kernel's time, the plain
     version's, the bound and scaled_dot_product_attention's (a yardstick
     the port never calls);
  5. parity on the card: the overfit parity model of
     tests/goldens/parity_vanilla.npz (loaded with numpy through the
     port's weights bridge, its audio rebuilt and checked against the
     stored hash) decodes both songs at max_length 1024 through
     fused_int4, fused and fused_bf16 with no token off the golden, and
     the probe ladder walks it as the JAX ladder does (int4 demoted for a
     material flip, int8 kept); then parity_withprev.npz (contiguous)
     through the exact path and the three window tiers and parity_v1.npz
     through the exact path, no token off; and the withprev model at
     bf16 gives the same tokens with its memory encoder on the kernel and
     on einsum;
  6. main path: the handler exactly as `python -m mr_mt3_tpu_torch.serve`
     builds and prepares it (configs/config.yaml, model=MT3Net, seed-0
     random weights, default tier fused_int4, probe ladder and prewarm on),
     serving WAV clips over HTTP from two concurrent clients; the ladder's
     walk is printed, and no demotion may come from an exception;
  7. segment-memory main path: the same for `python -m
     mr_mt3_tpu_torch.serve model=MT3NetSegMemV2WithPrev
     trainer.precision=bf16` (the paper's model, chained decode); the
     fused_attention launches must equal the long attentions the model
     ran (memory-encoder calls and teacher-forced forwards at L >= 512);
  8. serving through each window tier held (fused_int4, fused, fused_bf16;
     prepare_handler(probe=False)): the same clips, every answer MIDI;
  9. one worst-case decode (B=8, 1024 steps) on each window tier and on
     the exact path (fp32, TF32 off), and one chained segment-memory
     decode on fused_bf16 (8 chains x 8 segments x 1024 steps).
Launch counts are zeroed just before each of phases 6, 7 and 8 and read
just after; the window launches must cover every window the decoded tokens
needed. Then one JSON line of kernel numbers, the card line, and the
result line.
"""

import json
import os
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, 'chiprun_out')

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# bf16 tensor-core FLOP/s. The bound below is against these.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12

# Kernel vs plain version. Both sum in f32 but in different orders, so a
# bf16-rounded activation may land one bf16 ulp (2^-8 relative) apart;
# such flips pass from layer to layer (a flipped input moves every output
# of the next projection a little, which flips some of its roundings), and
# the unscaled attention over up to 1024 cache rows amplifies them. In the
# integer modes the same order differences move the f32 K/V values by
# about as much (~1% of the largest |value|), which at int8's step (1/127
# of a row's max) moves many codes by one or a few steps; and the integer
# attention requantizes q and the probabilities per (row, head), so a
# value that moves across a rounding tie moves a score or a probability
# by a whole step, which the softmax over up to 1024 cache rows amplifies.
# Each case reads, per batch row up to its first divergence:
#   kv_rel_err              bf16 K/V rows, largest |difference| over the
#                           largest |row| of the compared steps;
#   kv_rel_err_beyond_step  integer modes: dequantized rows (code x
#                           scale), the part of the difference beyond one
#                           quantization step of the row, over the largest
#                           |value|;
#   codes_unequal           share of K/V codes not equal;
#   first_layer_codes_unequal  the same over the second layer's K/V rows
#                           of the window's first step only, which follow
#                           one layer of attention from equal inputs: the
#                           sum-order differences flip codes there only at
#                           rare ties, while a wrong attention moves them
#                           all;
#   code_max_diff           largest |code difference|;
#   scale_rel_err           per-row scales, over the largest scale;
#   logit_rel_err           last-step logits of the rows whose tokens all
#                           agree, over the largest |logit|;
#   max_gap_rel             at each row's first divergence, the plain
#                           version's score of its token minus its score of
#                           the kernel's, over the step's largest |logit|
#                           (a divergence is allowed only at a near-tie);
# and a case in which every unfinished row diverges fails, since no logits
# of an unfinished row are then compared.
# The bounds of each mode, with the largest reading over the six cases of
# runs E, F and G (NVIDIA H100 80GB HBM3, 700 W; PERF.md, H100 port);
# fused_bf16 keeps the bounds it was first ported with (the gap bound is
# 2 x its logit bound). Each integer case also runs the control (float_attention_control)
# and fails unless the control breaks a bound: in run G its smallest
# first_layer_codes_unequal was 0.214 (int8) and 0.0123 (int4), and it
# broke that bound in all twelve cases.
BOUNDS = {
    'fused_bf16': {'kv_rel_err': 4e-2,              # read 0.0212
                   'logit_rel_err': 3e-2,           # 0.0151
                   'max_gap_rel': 6e-2},            # 0.0182
    'fused': {'kv_rel_err_beyond_step': 6e-2,       # 0.0346
              'codes_unequal': 0.30,                # 0.2008
              'first_layer_codes_unequal': 5e-2,    # 0.0140 (G)
              'code_max_diff': 24,                  # 12
              'scale_rel_err': 5e-2,                # 0.0256
              'logit_rel_err': 6e-2,                # 0.0321
              'max_gap_rel': 5e-2},                 # 0.0195
    'fused_int4': {'kv_rel_err_beyond_step': 3e-2,  # 0.0110
                   'codes_unequal': 0.03,           # 0.0100
                   'first_layer_codes_unequal': 2e-3,  # 0.0002 (G)
                   'code_max_diff': 2,              # 1
                   'scale_rel_err': 6e-2,           # 0.0298
                   'logit_rel_err': 1e-1,           # 0.0628
                   'max_gap_rel': 4e-2},            # 0.0136
}
TIMED_RUNS = 20
# the plain version is thousands of host-launched ops (~1 s a window): its
# median over fewer runs, with no warm-up beyond the comparison's own call
# (its time measures the host, PERF.md)
PLAIN_TIMED_RUNS = 3
TIERS = ('fused_bf16', 'fused', 'fused_int4')


def fail(msg):
    print(f'chip_smoke FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name):
    print(f'== {name}', flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True)
    if out.returncode != 0:
        fail(f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


def environment(torch):
    phase('environment')
    print(card_line())
    nvcc = subprocess.run(['bash', '-c', 'nvcc --version || '
                           '/usr/local/cuda/bin/nvcc --version'],
                          capture_output=True, text=True)
    nvcc_v = (nvcc.stdout.strip().splitlines() or ['nvcc not found'])[-1]
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}, {nvcc_v}')
    print(f'device: {torch.cuda.get_device_name(0)}, '
          f'{torch.cuda.device_count()} visible')


def build_kernels():
    """Build every csrc/*.cu in parallel (one nvcc each); print ptxas."""
    phase('build')
    from concurrent.futures import ThreadPoolExecutor

    from mr_mt3_tpu_torch.ops import cuda_build
    names = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC_DIR)
                   if f.endswith('.cu'))
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(names)) as pool:
        results = list(pool.map(
            lambda n: cuda_build.build(n, verbose=True), names))
    for name, (path, log) in zip(names, results):
        regs = [ln.strip() for ln in log.splitlines()
                if 'registers' in ln or 'spill' in ln]
        print(f'built {name} -> {os.path.relpath(path, REPO)}')
        for ln in regs:
            print(f'  ptxas: {ln}')
    print(f'build seconds: {time.monotonic() - t0:.1f}')


def window_bound_ms(cfg, batch, pos0, lenc, t_window, tier='fused_bf16'):
    """Least time for one window as a function: each input byte read once
    (only the cache rows < pos0 and the embedding rows the window uses),
    each output byte written once, against HBM bandwidth; and its
    operations: the projections' multiply-adds at the bf16 tensor-core
    peak, the attention dots at the bf16 peak (fused_bf16) or the int8
    peak (integer modes). Each tier counts its own bytes: weights and K/V
    codes at 2 B (bf16), 1 B (int8) or 0.5 B (int4), plus the f32 scales
    (per column, per position, per emitted row). Returns (ms, bound_by)."""
    L, H, dk, D = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv, cfg.d_model
    inner, F, V = cfg.inner_dim, cfg.d_ff, cfg.vocab_size
    width = {'fused_bf16': 2, 'fused': 1, 'fused_int4': 0.5}[tier]
    scaled = tier != 'fused_bf16'
    per_layer = D * 3 * inner + inner * D + D * inner + inner * D \
        + D * 2 * F + F * D
    cols = 3 * inner + D + inner + D + 2 * F + D     # column scales a layer
    weights = width * (L * per_layer + D * V) + 4 * (L * 3 * D + D)
    if scaled:
        weights += 4 * (L * cols + V)
    kv_pos = L * H * batch * (lenc + pos0)           # K/V positions read
    read = (weights + 2 * t_window * batch * D + 4 * t_window * D
            + 2 * kv_pos * (width * dk + (4 if scaled else 0)) + 8 * batch)
    rows = 2 * t_window * L * H * batch              # emitted K/V rows
    written = 4 * t_window * batch + 4 * batch + (
        rows * (dk + 4) if scaled else rows * 2 * dk)
    proj = t_window * 2 * batch * (L * per_layer + D * V)
    attn = 0
    for t in range(t_window):
        attn += L * batch * H * 2 * 2 * dk * (pos0 + t + 1 + lenc)
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = proj / BF16_FLOPS + attn / (INT8_OPS if scaled else BF16_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def time_ms(torch, fn, runs=TIMED_RUNS, warmup=2):
    """Median per-call device time: CUDA events between back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    events[0].record()
    for i in range(runs):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(runs))


def compare_window(torch, cfg, tier, got, want, logits, last_logits):
    """Per batch row: tokens equal up to a first divergence (its score gap
    read from the plain version's logits); the window's K/V rows compared
    up to that step (bf16 rows; or integer codes and their per-row scales,
    dequantized as code x scale); last-step logits compared for rows whose
    tokens all agree. Returns the readings named above the bounds."""
    exact = tier == 'fused_bf16'
    toks_k, fin_k, rows_k = got[0].cpu(), got[1].cpu(), \
        {k: v.cpu() for k, v in got[2].items()}
    toks_p, fin_p, rows_p = want[0].cpu(), want[1].cpu(), \
        {k: v.cpu() for k, v in want[2].items()}
    logits, last_logits = logits.cpu(), last_logits.cpu()
    T, B = toks_p.shape
    H = cfg.num_heads
    diverged, max_gap = [], 0.0
    equal = total = code_diff = flags_differ = 0
    kv_err = kv_excess = kv_scale = scale_err = scale_max = 0.0
    logit_err = logit_scale = 0.0
    for b in range(B):
        diff = (toks_k[:, b] != toks_p[:, b]).nonzero()
        last = T - 1
        if len(diff):
            d = int(diff[0])
            row = logits[d, b]
            gap = float(row[toks_p[d, b]] - row[toks_k[d, b]])
            max_gap = max(max_gap, gap / float(row.abs().max()))
            diverged.append((b, d))
            last = d
        else:
            flags_differ += int(not torch.equal(fin_k[b], fin_p[b]))
            logit_err = max(logit_err, float(
                (last_logits[b] - logits[T - 1, b]).abs().max()))
            logit_scale = max(logit_scale,
                              float(logits[T - 1, b].abs().max()))

        def row_b(t):          # (T, L, H*B, ...) -> steps <= last of row b
            return t[:last + 1].reshape(last + 1, -1, H, B,
                                        *t.shape[3:])[:, :, :, b]
        for key in ('k', 'v'):
            a, r = row_b(rows_k[key + 'q']), row_b(rows_p[key + 'q'])
            if exact:
                a, r = a.float(), r.float()
            else:
                sk, sp = row_b(rows_k[key + 's']), row_b(rows_p[key + 's'])
                equal += int((a == r).sum())
                total += a.numel()
                code_diff = max(code_diff,
                                int((a.int() - r.int()).abs().max()))
                scale_err = max(scale_err, float((sk - sp).abs().max()))
                scale_max = max(scale_max, float(sp.abs().max()))
                a, r = a.float() * sk[..., None], r.float() * sp[..., None]
                kv_excess = max(kv_excess, float(
                    ((a - r).abs() - sp[..., None]).max()))
            kv_err = max(kv_err, float((a - r).abs().max()))
            kv_scale = max(kv_scale, float(r.abs().max()))
    # the last row starts finished and is checked for pad by the caller
    unfinished_agreeing = B - 1 - sum(1 for b, _ in diverged if b < B - 1)
    out = {'max_abs_err': kv_err, 'kv_rel_err': kv_err / kv_scale,
           'logit_rel_err': logit_err / max(logit_scale, 1e-30),
           'rows_diverged': len(diverged), 'max_gap_rel': max_gap,
           'unfinished_rows_agreeing': unfinished_agreeing,
           'finished_flags_differ': flags_differ}
    if not exact:
        first_layer = max(float((rows_k[k][0, 1] != rows_p[k][0, 1])
                                .float().mean()) for k in ('kq', 'vq'))
        out.update({'kv_rel_err_beyond_step': kv_excess / kv_scale,
                    'codes_unequal': 1 - equal / total,
                    'first_layer_codes_unequal': first_layer,
                    'code_max_diff': code_diff,
                    'scale_rel_err': scale_err / scale_max})
    return out


def violations(tier, readings):
    """The readings past their mode's bounds, as messages."""
    bad = [f'{key} {readings[key]:.4g} > {bound}'
           for key, bound in BOUNDS[tier].items() if readings[key] > bound]
    if readings['unfinished_rows_agreeing'] < 1:
        bad.append('every unfinished row diverged, so no logits were '
                   'compared')
    if readings['finished_flags_differ']:
        bad.append('finished flags differ with equal tokens')
    return bad


def float_attention_control(torch, fd, args):
    """A deliberately wrong plain version of an integer mode: attention
    over cache and cross rows in f32 against the dequantized codes, with
    no int8 requantization of q and the probabilities. The bounds must
    tell the kernel from it: a kernel that skipped the requantization
    would fail them."""
    def scores(q, codes, scale):
        return torch.einsum('bhd,hbdp->bhp', q, codes) \
            * scale.transpose(0, 1)

    def values(p, codes, scale):
        return torch.einsum('bhp,hbdp->bhd', p * scale.transpose(0, 1),
                            codes)
    real = fd._int_scores, fd._int_values
    fd._int_scores, fd._int_values = scores, values
    try:
        return fd.fused_decode_window_reference(*args, return_logits=True)
    finally:
        fd._int_scores, fd._int_values = real


def kernel_cases(torch):
    """Window kernel vs its plain version at full width on the card."""
    phase('kernel vs plain (full width)')
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params
    from mr_mt3_tpu_torch.utils.builders import init_params

    cfg = MT3Config()
    dev = torch.device('cuda')
    model = init_params(MT3(cfg), seed=0).to(dev).eval()
    T = fd.FUSED_WINDOW
    # (batch, pos0, Lenc): vanilla MT3's 256 encoder rows, and the segment-
    # memory model's 256 + 64 memory rows at 8 chains and at the per-call
    # cap of 64 chains
    cases = [(b, p, 256) for b in (8, 64) for p in (0, 32, 992)] \
        + [(b, 992, 320) for b in (8, 64)]
    results, bad = {}, []
    for tier in TIERS:
        dp = stack_decode_params(model, quantize=tier)
        fp = dp.fused
        results[tier] = []
        # the same seeded encoder states and tokens for every tier
        gen = torch.Generator().manual_seed(1)
        for batch, pos0, lenc in cases:
            enc = (torch.randn((batch, lenc, cfg.d_model), generator=gen)
                   * 0.5).to(dev)
            cross = fd.precompute_cross_kv_fused(dp, cfg, enc)
            cache = fd.init_fused_cache(cfg, batch, 1024, dev, tier)
            tokens = torch.randint(3, cfg.vocab_size, (batch,),
                                   generator=gen, dtype=torch.int32).to(dev)
            finished = torch.zeros(batch, dtype=torch.bool, device=dev)
            # rows < pos0 hold what a decode leaves there: decode up to
            # pos0 with the kernel itself (chained windows)
            for p in range(0, pos0, T):
                toks_w, finished, cache = fd.fused_decode_window(
                    cfg, fp, dp, tokens, finished, p, cache, cross, T)
                tokens = toks_w[:, -1].contiguous()
            finished = finished.clone()
            finished[batch - 1] = True      # a finished row must emit pad
            pos_rows = fd.window_pos_rows(dp, pos0, T)
            args = (cfg, fp, pos_rows, tokens, finished, pos0, cache, cross,
                    T)
            last_logits = torch.empty((batch, cfg.vocab_size), device=dev)
            got = fd.fused_decode_window_cuda(*args, logits_out=last_logits)
            torch.cuda.synchronize()
            want = fd.fused_decode_window_reference(*args,
                                                    return_logits=True)
            if not bool((got[0][:, batch - 1] == cfg.pad_token_id).all()):
                fail(f'{tier}: a finished row emitted a non-pad token')
            errs = compare_window(torch, cfg, tier, got, want[:3], want[3],
                                  last_logits)
            name = f'{tier} B={batch} pos0={pos0} Lenc={lenc}'
            bad += [f'{name}: {v}' for v in violations(tier, errs)]
            if tier != 'fused_bf16':
                ctrl = float_attention_control(torch, fd, args)
                ctrl = compare_window(torch, cfg, tier, got, ctrl[:3],
                                      ctrl[3], last_logits)
                caught = violations(tier, ctrl)
                errs['control'] = {k: ctrl[k] for k in BOUNDS[tier]}
                errs['control_caught_by'] = caught
                if not caught:
                    bad.append(f'{name}: the bounds do not tell the '
                               f'kernel from the f32 attention control')
            ms = time_ms(torch, lambda: fd.fused_decode_window_cuda(*args))
            plain_ms = time_ms(
                torch, lambda: fd.fused_decode_window_reference(*args),
                runs=PLAIN_TIMED_RUNS, warmup=0)
            bound, bound_by = window_bound_ms(cfg, batch, pos0, lenc, T,
                                              tier)
            case = {'tier': tier, 'batch': batch, 'pos0': pos0,
                    'lenc': lenc, **errs,
                    'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound,
                    'bound_by': bound_by}
            print(json.dumps(case), flush=True)
            results[tier].append(case)
        del dp, fp, cross, cache
    if bad:
        fail('kernel vs plain version: ' + '; '.join(bad))
    return results


def wav_bytes(samples, sr=16000):
    pcm = (samples.clip(-1, 1) * 32767).astype('<i2').tobytes()
    return (b'RIFF' + struct.pack('<I', 36 + len(pcm)) + b'WAVE'
            + b'fmt ' + struct.pack('<IHHIIHH', 16, 1, 1, sr, sr * 2, 2, 16)
            + b'data' + struct.pack('<I', len(pcm)) + pcm)


def clip(seconds, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    x = sum(0.2 * np.sin(2 * np.pi * f * t)
            for f in 220.0 * 2 ** (rng.integers(0, 24, 3) / 12))
    return (x + 1e-3 * rng.normal(size=t.shape)).astype(np.float32)


def windows_needed(tokens, batch, max_length, eos_id, fused_window):
    """Windows the fused decode driver must run to give `tokens` (N,
    max_length + 1), decoded in batches of `batch` rows: per batch, up to
    the window holding the last row's first EOS, or every window when a
    row never emits one. Returns (decode calls, windows)."""
    import numpy as np
    t_win = min(fused_window, max(8, -(-max_length // 8) * 8))
    all_windows = -(-max_length // t_win)
    calls = windows = 0
    for start in range(0, len(tokens), batch):
        steps = []
        for row in tokens[start:start + batch, 1:]:
            eos = np.flatnonzero(row == eos_id)
            steps.append(int(eos[0]) + 1 if len(eos) else max_length + 1)
        calls += 1
        windows += min(all_windows, (max(steps) - 1) // t_win + 1)
    return calls, windows


def serve_clips(torch, handler, info):
    """Serve the 4 WAV clips from two concurrent clients through the
    port's HTTP server around `handler`; every answer must be MIDI.
    Returns the /healthz payload."""
    from mr_mt3_tpu_torch import serve
    server = serve.make_server(handler, 0, info)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f'http://127.0.0.1:{server.server_address[1]}'
    clips = [(2.5, 0), (4.0, 1), (6.0, 2), (9.5, 3)]
    replies = {}

    def client(jobs):
        for seconds, seed in jobs:
            req = urllib.request.Request(
                url + '/transcribe', data=wav_bytes(clip(seconds, seed)),
                method='POST')
            t1 = time.monotonic()
            with urllib.request.urlopen(req, timeout=600) as resp:
                replies[seed] = (resp.status, resp.read(),
                                 time.monotonic() - t1)

    try:
        t1 = time.monotonic()
        clients = [threading.Thread(target=client, args=(clips[i::2],))
                   for i in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        wall = time.monotonic() - t1
        with urllib.request.urlopen(url + '/healthz', timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    for seconds, seed in clips:
        if seed not in replies:
            fail(f'no reply for the {seconds} s clip')
        status, body, secs = replies[seed]
        if status != 200 or body[:4] != b'MThd':
            fail(f'{seconds} s clip: HTTP {status}, body {body[:16]!r}')
        print(f'clip {seconds} s -> {len(body)} MIDI bytes in {secs:.2f} s')
    print(f'{len(clips)} requests in {wall:.2f} s wall')
    return health


class DecodeLog:
    """Records every InferenceHandler._decode_all call (the server's
    handler, the probe's twins, the prewarm) with its tier, batch and
    length, to work out how many windows each kernel mode had to run."""

    def __init__(self):
        from mr_mt3_tpu_torch.infer import InferenceHandler
        self.cls = InferenceHandler
        self.real = InferenceHandler._decode_all
        self.calls = []
        log = self

        def recording(handler, mel):
            tokens = log.real(handler, mel)
            log.calls.append((handler.quantize, handler.batch_size,
                              handler.max_length, handler.cfg.eos_token_id,
                              tokens))
            return tokens
        InferenceHandler._decode_all = recording

    def close(self):
        self.cls._decode_all = self.real

    def windows(self, tier):
        """(decode calls, windows) the decodes on `tier` needed."""
        from mr_mt3_tpu_torch.ops import fused_decode as fd
        calls = windows = 0
        for quantize, batch, max_length, eos_id, tokens in self.calls:
            if quantize == tier:
                c, w = windows_needed(
                    tokens, min(batch, fd.FUSED_MAX_BATCH), max_length,
                    eos_id, fd.FUSED_WINDOW)
                calls, windows = calls + c, windows + w
        return calls, windows


def check_launches(launches, log, tiers):
    """Each tier's launches cover the windows its decodes needed."""
    for tier in tiers:
        calls, windows = log.windows(tier)
        print(f'{tier}: {launches[tier]} window launches for {windows} '
              f'windows over {calls} decode calls')
        if windows < calls or launches[tier] < windows:
            fail(f'{tier}: {launches[tier]} kernel launches for {windows} '
                 f'windows decoded')


class ProbeWalk:
    """Stands in for serve.quantize_probe, the server's probe entry point,
    until closed, recording each probe of the ladder: its tier, length,
    counts and seconds, or the error it raised."""

    FIELDS = ('tier', 'length', 'flips', 'total', 'material_rows',
              'benign_rows', 'downstream_rows', 'material_margin',
              'margin_noise', 'classify_error', 'error', 'seconds')

    def __init__(self):
        from mr_mt3_tpu_torch import serve
        self.serve, self.real, self.steps = serve, serve.quantize_probe, []
        serve.quantize_probe = self.probe

    def probe(self, handler, max_length=None, **kw):
        t0 = time.monotonic()
        tier = handler.quantize
        try:
            res = self.real(handler, max_length=max_length, **kw)
        except Exception as e:
            self.steps.append({'tier': tier, 'error': repr(e)[:200]})
            raise
        step = {'tier': tier, 'length': max_length or 'short',
                'seconds': round(time.monotonic() - t0, 1)}
        if isinstance(res, dict):
            step.update(res)
        else:
            step['flips'], step['total'] = res
        self.steps.append(step)
        return res

    def close(self):
        self.serve.quantize_probe = self.real

    def print(self):
        for step in self.steps:
            print('ladder: ' + json.dumps({k: step.get(k)
                                            for k in self.FIELDS}))

    def check(self, handler, decode):
        """The /healthz decode block names the served tier, prewarmed; the
        walk started at fused_int4 and no probe, classification or
        demotion came from an exception."""
        if not decode.get('prewarmed') or decode.get('quantize') != \
                handler.quantize:
            fail(f'/healthz decode info: {decode}')
        errors = [st for st in self.steps
                  if 'error' in st or 'classify_error' in st]
        failed = [d for d in decode.get('demotions', []) if 'failed' in d]
        if errors or failed or 'probe_error' in decode or \
                'classify_error' in decode:
            fail(f'a probe raised: {errors or failed or decode}')
        if not self.steps or self.steps[0]['tier'] != 'fused_int4':
            fail('the ladder did not probe fused_int4')


def main_path(torch):
    """`python -m mr_mt3_tpu_torch.serve` as users start it: default tier
    fused_int4, probe ladder and prewarm on, then 4 clips over HTTP."""
    phase('main path: python -m mr_mt3_tpu_torch.serve equivalent')
    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.ops import fused_decode as fd

    for tier in TIERS:
        fd.LAUNCHES[tier] = 0
    log = DecodeLog()
    walk = ProbeWalk()
    try:
        t0 = time.monotonic()
        handler = serve.build_handler([])
        if handler.quantize != 'fused_int4':
            fail(f'default tier is {handler.quantize!r}, expected '
                 f'fused_int4')
        info = serve.prepare_handler(handler)
        print(f'handler built, probed and prewarmed in '
              f'{time.monotonic() - t0:.1f} s')
        walk.print()
        health = serve_clips(torch, handler, info)
    finally:
        walk.close()
        log.close()
    launches = dict(fd.LAUNCHES)
    decode = health['decode']
    print(f'healthz: {json.dumps(health)}')
    walk.check(handler, decode)
    check_launches(launches, log, TIERS)
    if launches['fused_int4'] < 1:
        fail('the int4 kernel was not launched on the main path')
    return {'tier': handler.quantize, 'walk': walk.steps,
            'launches': launches,
            'demotions': decode.get('demotions', [])}


def held_tier_serving(torch):
    """Serve the clips through a handler held at each window tier (the
    serve CLI with eval.quantize=<tier>, prepare_handler(probe=False))."""
    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    launches = {}
    for tier in TIERS:
        phase(f'serving held at {tier}')
        handler = serve.build_handler([f'eval.quantize={tier}'])
        for t in TIERS:
            fd.LAUNCHES[t] = 0
        log = DecodeLog()
        try:
            t0 = time.monotonic()
            info = serve.prepare_handler(handler, probe=False)
            print(f'prewarmed in {time.monotonic() - t0:.1f} s')
            health = serve_clips(torch, handler, info)
        finally:
            log.close()
        if health['decode'].get('quantize') != tier:
            fail(f'/healthz decode info: {health["decode"]}')
        check_launches(fd.LAUNCHES, log, (tier,))
        if len(log.calls) != health['batches'] + 1:
            fail(f'{len(log.calls)} decodes recorded for '
                 f'{health["batches"]} request batches and the prewarm')
        launches[tier] = fd.LAUNCHES[tier]
        del handler
        torch.cuda.empty_cache()
    return launches


# tests/parity_common.py:36 VANILLA_CFG: the overfit parity model's widths
PARITY_DIMS = dict(d_model=96, d_kv=24, d_ff=192, num_heads=4,
                   num_encoder_layers=2, num_decoder_layers=2)
# where the JAX package's probe ladder leaves the parity model (below)
PARITY_LADDER_TIER = 'fused'


def parity_corpus():
    """The two fixed parity songs (audios only): a numpy copy of
    tests/parity_common.py:91-123, which imports the JAX package."""
    import numpy as np
    rng = np.random.default_rng(2024)
    sr, t_total = 16000, 3 * 256 * 128
    audios = []
    for _ in range(2):
        audio = rng.normal(size=t_total).astype(np.float32) * 1e-3
        starts = np.sort(rng.choice(np.arange(1, 11), size=9,
                                    replace=False)) / 2.0
        for s in starts:
            pitch = int(rng.integers(55, 76))
            length = 0.4
            f = 440.0 * 2 ** ((pitch - 69) / 12)
            i0, i1 = int(s * sr), int((s + length) * sr)
            seg_t = np.arange(i1 - i0) / sr
            env = np.minimum(1, np.minimum(seg_t / 0.02,
                                           (length - seg_t) / 0.05))
            audio[i0:i1] += (0.5 * np.sin(2 * np.pi * f * seg_t)
                             * env).astype(np.float32)
        audios.append(audio)
    return audios


def parity_model(torch, name, **cfg_kw):
    """The overfit parity model of tests/goldens/<name> in the port, its
    weights loaded with numpy through the port's weights bridge; returns
    (model, golden tokens, max_length, the two corpus audios, checked
    against the stored hash)."""
    import hashlib

    import numpy as np

    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.utils.checkpoint_import import (
        state_dict_from_jax_params,
    )
    blob = np.load(os.path.join(REPO, 'tests', 'goldens', name))
    params = {}
    for key in blob.files:
        if key.startswith('param:'):
            node, parts = params, key[len('param:'):].split('/')
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = blob[key]
    audios = parity_corpus()
    sha = hashlib.sha256()
    for a in audios:
        sha.update(np.ascontiguousarray(a, np.float32).tobytes())
    want_sha = blob['audio_sha'].item()
    want_sha = want_sha.decode() if isinstance(want_sha, bytes) else want_sha
    if sha.hexdigest() != want_sha:
        fail('the rebuilt parity audio does not match audio_sha')
    cfg = MT3Config(**PARITY_DIMS, **cfg_kw)
    model = MT3(cfg).eval()
    model.load_state_dict(state_dict_from_jax_params(params, cfg),
                          strict=True)
    return model, blob['tokens'], int(blob['max_length']), audios


def parity_on_card(torch):
    """The overfit parity model through each window tier on the card: no
    token off the golden; then the probe ladder walks it as JAX does."""
    phase('parity on the card (tests/goldens/parity_vanilla.npz)')
    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.infer import InferenceHandler
    model, golden, max_length, audios = parity_model(
        torch, 'parity_vanilla.npz')
    flips = {}
    for tier in ('fused_int4', 'fused', 'fused_bf16'):
        handler = InferenceHandler(model=model, max_length=max_length,
                                   batch_size=4, quantize=tier)
        t0 = time.monotonic()
        flips[tier] = 0
        for song, audio in enumerate(audios):
            segments, _, valid = handler._audio_to_segments(audio)
            tokens = handler._decode_all(handler._compute_mel(segments,
                                                              valid))
            if tokens.shape != golden[song].shape:
                fail(f'{tier} song {song}: tokens {tokens.shape}, golden '
                     f'{golden[song].shape}')
            flips[tier] += int((tokens != golden[song]).sum())
        print(f'{tier}: {flips[tier]} of {golden.size} tokens off the '
              f'golden, both songs at max_length {max_length} '
              f'({time.monotonic() - t0:.1f} s)')
        if flips[tier]:
            fail(f'{tier} flipped {flips[tier]} golden tokens on the card')
    # The JAX package's own ladder, on the CPU with this model and the
    # probe audio, demotes fused_int4 for one material first flip (17 of
    # 514 probe tokens, first-flip margin 0.4607) and keeps fused; the
    # port's ladder gives the same dict there
    # (tests/test_torch_probe.py::TestAgainstJax::
    # test_parity_model_probe_equals_jax). The card must walk it the same
    # way, and never for an exception.
    handler = InferenceHandler(model=model, max_length=max_length,
                               batch_size=4, quantize='fused_int4')
    t0 = time.monotonic()
    info = serve.prepare_handler(handler)
    info['seconds'] = round(time.monotonic() - t0, 1)
    print(f'ladder on the parity model: {json.dumps(info)}')
    demotions = info.get('demotions', [])
    if handler.quantize != PARITY_LADDER_TIER or len(demotions) != 1 or \
            'material' not in demotions[0] or 'probe_error' in info:
        fail(f'the ladder on the parity model ended at '
             f'{handler.quantize!r}, not as the JAX ladder does '
             f'({PARITY_LADDER_TIER!r} after one material-flip demotion): '
             f'{info}')
    return {'flips': flips, 'ladder': info}


def worst_case(torch):
    """B=8, 1024-step decode on each window tier and the exact fp32 path."""
    phase('worst-case decode (B=8, max_length 1024)')
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.ops.decode import greedy_decode
    from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params
    from mr_mt3_tpu_torch.utils.builders import init_params

    cfg = MT3Config()
    dev = torch.device('cuda')
    model = init_params(MT3(cfg), seed=0).to(dev).eval()
    gen = torch.Generator().manual_seed(2)
    mel = torch.rand((8, 256, cfg.mel_bins), generator=gen).to(dev)
    audio_s = 8 * 256 * 128 / 16000
    out, rows = {}, {}
    for tier in ('fused_int4', 'fused', 'fused_bf16', 'none'):
        dp = stack_decode_params(model, quantize=tier)
        greedy_decode(model, mel[:, :, :], 32, quantize=tier, dp=dp)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        toks = greedy_decode(model, mel, 1024, quantize=tier, dp=dp)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        toks = toks.cpu()
        if toks.shape != (8, 1025) or int(toks.min()) < 0 or \
                int(toks.max()) >= cfg.vocab_size:
            fail(f'{tier}: bad tokens {tuple(toks.shape)}')
        steps = int((toks[:, 1:] != cfg.pad_token_id).sum(1).max())
        out[tier] = toks
        rows[tier] = {'seconds': secs, 'steps': steps,
                      'ms_per_step': secs / max(steps, 1) * 1e3,
                      'rtf': audio_s / secs}
        print(f'{tier}: {secs:.3f} s, {steps} steps decoded, '
              f'{secs / max(steps, 1) * 1e3:.4f} ms/step, '
              f'realtime factor {audio_s / secs:.2f}')
    for tier in ('fused_int4', 'fused', 'fused_bf16'):
        agree = float((out[tier] == out['none']).float().mean())
        rows[tier]['agreement_with_exact'] = agree
        print(f'{tier} vs exact token agreement: {agree:.4f}')
    return rows


# fused_attention_fwd against its plain version on the same inputs: both
# keep f32 scores and an f32 softmax and sum in other orders (the kernel's
# bf16 products on the tensor cores), so an output or a probability near a
# bf16 rounding midpoint rounds one ulp apart. Bounds at about 3x the
# largest reading over the cases of the calibration run (run J, NVIDIA
# H100 80GB HBM3, 700 W; PERF.md, H100 port): rel_err, the largest
# |difference| over the largest |plain output|, read 0.0035 (one bf16 ulp
# of the largest output); unequal, the share of outputs not equal, 4.5e-4.
ATTN_BOUNDS = {'rel_err': 1e-2, 'unequal': 1.5e-3}
# (name, batch, Lq, Lk, heads, head width, causal): the memory encoder
# (B 8 chains, and 64, the per-call cap), the probe's teacher-forced
# decoder self-attention and cross-attention (Lk 256 + 64 = 320, padded
# to 384) at full width, and the parity model's head width 24
ATTN_CASES = [
    ('memory_encoder_b8', 8, 1024, 1024, 6, 64, False),
    ('memory_encoder_b64', 64, 1024, 1024, 6, 64, False),
    ('decoder_causal_b8', 8, 1024, 1024, 6, 64, True),
    ('cross_1024x320_b8', 8, 1024, 320, 6, 64, False),
    ('parity_d24_b8', 8, 1024, 1024, 4, 24, False),
]


def attention_bound_ms(b, lq, lk, kv_valid, h, d, causal):
    """Least time for the call as a function: q, the kv_valid K/V rows and
    the output moved once (bf16), against HBM; and the multiply-adds this
    data needs (q.k and p.v over the columns each row sees) at the bf16
    tensor-core peak. Returns (ms, bound_by)."""
    cols = sum(min(kv_valid, i + 1) if causal else kv_valid
               for i in range(lq))
    flops = 4 * b * h * d * cols
    nbytes = 2 * b * h * d * (2 * lq + 2 * kv_valid)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def attention_cases(torch):
    """fused_attention_fwd vs its plain version at the main path's shapes:
    fused_attention (the wrapper models/mt3.py calls) on the unpadded K/V
    against fused_attention_reference on K/V padded by _pad_kv. Then the
    kernel's time (fused_attention_cuda on the padded K/V), the plain
    version's, the bound and PyTorch's scaled_dot_product_attention (scale
    1.0, the same padded tensors, the kv_valid mask as a boolean
    attn_mask) as a yardstick."""
    phase('fused_attention_fwd vs plain (full width)')
    import torch.nn.functional as F

    from mr_mt3_tpu_torch.ops import train_attention as ta
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(3)
    results, bad = [], []
    for name, b, lq, lk, h, d, causal in ATTN_CASES:
        q, k, v = [torch.randn((b, n, h, d), generator=gen).to(
            dev, torch.bfloat16) for n in (lq, lk, lk)]
        before = ta.LAUNCHES[ta.KERNEL]
        got = ta.fused_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if ta.LAUNCHES[ta.KERNEL] != before + 1:
            fail(f'{name}: fused_attention did not launch the kernel')
        kp, vp, valid = ta._pad_kv(k, v)
        want = ta.fused_attention_reference(q, kp, vp, causal, valid)
        diff = (got.float() - want.float()).abs()
        scale = float(want.float().abs().max())
        readings = {'max_abs_err': float(diff.max()),
                    'rel_err': float(diff.max()) / scale,
                    'unequal': float((got != want).float().mean())}
        bad += [f'{name}: {key} {readings[key]:.4g} > {bound}'
                for key, bound in ATTN_BOUNDS.items()
                if readings[key] > bound]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kp, vp))
        mask = None
        if valid < kp.shape[1]:
            mask = (torch.arange(kp.shape[1], device=dev) < valid).expand(
                lq, kp.shape[1])

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal, scale=1.0)
        lib_out = library().transpose(1, 2).float()
        ms = time_ms(torch, lambda: ta.fused_attention_cuda(
            q, kp, vp, causal, valid))
        plain_ms = time_ms(torch, lambda: ta.fused_attention_reference(
            q, kp, vp, causal, valid), runs=PLAIN_TIMED_RUNS, warmup=0)
        library_ms = time_ms(torch, library)
        bound, bound_by = attention_bound_ms(b, lq, kp.shape[1], valid, h,
                                             d, causal)
        case = {'case': name, 'batch': b, 'lq': lq, 'lk': kp.shape[1],
                'kv_valid': valid, 'heads': h, 'head_width': d,
                'causal': causal, **readings,
                'library_rel_diff': float((lib_out - want.float()).abs()
                                          .max()) / scale,
                'ms': ms, 'plain_ms': plain_ms, 'library_ms': library_ms,
                'bound_ms': bound, 'bound_by': bound_by}
        print(json.dumps(case), flush=True)
        results.append(case)
        del q, k, v, kp, vp, got, want, diff, lib_out
        torch.cuda.empty_cache()
    if bad:
        fail('fused_attention_fwd vs plain version: ' + '; '.join(bad))
    return results


# tests/parity_common.py:39-42: the segment-memory parity models
WITHPREV_KW = dict(segmem_variant='encoder_append', segmem_length=16)
V1_KW = dict(segmem_variant='decoder_prepend', segmem_length=16,
             segmem_seed='eos')


def segmem_parity_on_card(torch):
    """parity_withprev.npz contiguous through the exact path and the three
    window tiers, parity_v1.npz through the exact path: no token off the
    golden. Then the withprev model at bf16, its memory encoder on the
    kernel and on einsum: the same tokens."""
    phase('segment-memory parity on the card (parity_withprev.npz, '
          'parity_v1.npz)')
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.ops import train_attention as ta

    def decode_songs(model, quantize, audios, max_length):
        handler = InferenceHandler(model=model, max_length=max_length,
                                   contiguous_inference=True,
                                   segment_bucket=1, quantize=quantize)
        out = []
        for audio in audios:
            segments, _, valid = handler._audio_to_segments(audio)
            out.append(handler._decode_all(handler._compute_mel(segments,
                                                                valid)))
        return out

    flips = {}
    for name, kw, tiers in (
            ('parity_withprev.npz', WITHPREV_KW, ('none',) + TIERS),
            ('parity_v1.npz', V1_KW, ('none',))):
        model, golden, max_length, audios = parity_model(torch, name, **kw)
        for tier in tiers:
            t0 = time.monotonic()
            tokens = decode_songs(model, tier, audios, max_length)
            off = sum(int((t != g).sum()) for t, g in zip(tokens, golden))
            flips[f'{name}:{tier}'] = off
            print(f'{name} {tier}: {off} of {golden.size} tokens off the '
                  f'golden, contiguous, max_length {max_length} '
                  f'({time.monotonic() - t0:.1f} s)')
            if off:
                fail(f'{name} {tier} flipped {off} golden tokens on the '
                     f'card')
    # the withprev model at bf16: memory encoder through the kernel, then
    # through einsum; the exact decode path in both
    bf16 = {}
    for kernel in ('fused', 'einsum'):
        model, golden, max_length, audios = parity_model(
            torch, 'parity_withprev.npz', dtype='bfloat16',
            attention_kernel=kernel, **WITHPREV_KW)
        ta.LAUNCHES[ta.KERNEL] = 0
        bf16[kernel] = decode_songs(model, 'none', audios, max_length)
        launches = ta.LAUNCHES[ta.KERNEL]
        off = sum(int((t != g).sum()) for t, g in zip(bf16[kernel], golden))
        print(f'withprev at bf16, attention_kernel={kernel!r}: {off} of '
              f'{golden.size} tokens off the fp32 golden, {launches} '
              f'fused_attention launches')
        if (launches > 0) != (kernel == 'fused'):
            fail(f'attention_kernel={kernel!r} launched the kernel '
                 f'{launches} times')
        flips[f'withprev_bf16_{kernel}_vs_fp32_golden'] = off
    differ = sum(int((a != b).sum()) for a, b in zip(bf16['fused'],
                                                     bf16['einsum']))
    print(f'bf16 withprev: {differ} tokens differ between the kernel and '
          f'einsum')
    if differ:
        fail(f'the bf16 withprev tokens differ between the kernel and '
             f'einsum in {differ} places')
    flips['bf16_kernel_vs_einsum'] = differ
    return flips


class SegmemLog:
    """Records every memory-chain decode (InferenceHandler._segmem_decode)
    with its tier, length, tokens and valid rows, every memory-encoder
    call (MT3.compute_segmem) and every teacher-forced forward, to work out
    the window launches the chains needed and the fused_attention launches
    the model's long attentions make."""

    def __init__(self):
        from mr_mt3_tpu_torch.infer import InferenceHandler
        from mr_mt3_tpu_torch.models import MT3
        from mr_mt3_tpu_torch.models import mt3
        self.handler_cls, self.model_cls = InferenceHandler, MT3
        self.real = (InferenceHandler._segmem_decode, MT3.compute_segmem,
                     MT3.forward)
        self.decodes, self.attention_calls = [], 0
        self.memory_encoder_calls = self.forwards = 0
        log = self

        def fused(model, length):
            """Whether a full-sequence attention at this length takes the
            kernel: the model's rule (mt3.Attention._fused_eligible)."""
            return length >= mt3._FUSED_MIN_LEN and length % 8 == 0 and \
                mt3.resolve_attention_kernel(
                    model.cfg, model.proj.weight.device) == 'fused'

        def segmem_decode(handler, mel_segments, valid_mask):
            tokens = log.real[0](handler, mel_segments, valid_mask)
            log.decodes.append((handler.quantize, handler.max_length,
                                handler.cfg.eos_token_id, tokens,
                                valid_mask.cpu().numpy()))
            return tokens

        def compute_segmem(model, prev_ids):
            log.memory_encoder_calls += 1
            if fused(model, prev_ids.shape[1]):
                log.attention_calls += model.cfg.segmem_num_layers
            return log.real[1](model, prev_ids)

        def forward(model, mel, decoder_input_ids, targets_prev=None):
            log.forwards += 1
            if fused(model, decoder_input_ids.shape[1]):
                # each decoder layer: causal self- and cross-attention
                log.attention_calls += 2 * model.cfg.num_decoder_layers
            return log.real[2](model, mel, decoder_input_ids, targets_prev)
        InferenceHandler._segmem_decode = segmem_decode
        MT3.compute_segmem = compute_segmem
        MT3.forward = forward

    def close(self):
        (self.handler_cls._segmem_decode, self.model_cls.compute_segmem,
         self.model_cls.forward) = self.real

    def windows(self, tier):
        """(chain decodes, windows) the chains on `tier` needed: per
        segment, up to the window of the last valid row's first EOS."""
        from mr_mt3_tpu_torch.ops import fused_decode as fd
        calls = windows = 0
        for quantize, max_length, eos_id, tokens, valid in self.decodes:
            if quantize != tier:
                continue
            calls += 1
            for s in range(tokens.shape[1]):
                _, w = windows_needed(tokens[valid, s], len(tokens),
                                      max_length, eos_id, fd.FUSED_WINDOW)
                windows += w
        return calls, windows


SEGMEM_ARGS = ['model=MT3NetSegMemV2WithPrev', 'trainer.precision=bf16']


def segmem_main_path(torch):
    """`python -m mr_mt3_tpu_torch.serve model=MT3NetSegMemV2WithPrev
    trainer.precision=bf16` as users start it: the paper's model at full
    width, seed-0 random weights, default tier fused_int4, probe ladder and
    prewarm on, then the WAV clips over HTTP from two clients."""
    phase('segment-memory main path: python -m mr_mt3_tpu_torch.serve '
          + ' '.join(SEGMEM_ARGS))
    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops import train_attention as ta

    for tier in TIERS:
        fd.LAUNCHES[tier] = 0
    ta.LAUNCHES[ta.KERNEL] = 0
    log = SegmemLog()
    walk = ProbeWalk()
    try:
        t0 = time.monotonic()
        handler = serve.build_handler(SEGMEM_ARGS)
        cfg = handler.cfg
        if handler.quantize != 'fused_int4' or \
                cfg.segmem_variant != 'encoder_append' or \
                cfg.dtype != 'bfloat16' or handler.contiguous_inference:
            fail(f'the segmem server is not the paper model at bf16, '
                 f'chained, from fused_int4: {cfg}, {handler.quantize!r}')
        info = serve.prepare_handler(handler)
        ready = time.monotonic() - t0
        print(f'handler built, probed and prewarmed in {ready:.1f} s '
              f'(prewarm buckets {info.get("prewarm_buckets")}, '
              f'{info.get("prewarm_seconds")} s)')
        walk.print()
        health = serve_clips(torch, handler, info)
    finally:
        walk.close()
        log.close()
    launches = dict(fd.LAUNCHES)
    launches[ta.KERNEL] = ta.LAUNCHES[ta.KERNEL]
    decode = health['decode']
    print(f'healthz: {json.dumps(health)}')
    walk.check(handler, decode)
    for tier in TIERS:
        calls, windows = log.windows(tier)
        print(f'{tier}: {launches[tier]} window launches for {windows} '
              f'windows over {calls} chain decodes')
        if launches[tier] < windows:
            fail(f'{tier}: {launches[tier]} kernel launches for {windows} '
                 f'windows decoded')
    if launches['fused_int4'] < 1:
        fail('the int4 window kernel was not launched on the segmem path')
    print(f'{ta.KERNEL}: {launches[ta.KERNEL]} launches for '
          f'{log.attention_calls} long attentions ('
          f'{log.memory_encoder_calls} memory-encoder calls, '
          f'{log.forwards} teacher-forced forwards)')
    if launches[ta.KERNEL] != log.attention_calls or \
            log.attention_calls < 1:
        fail(f'{ta.KERNEL}: {launches[ta.KERNEL]} launches for '
             f'{log.attention_calls} long attentions')
    return {'tier': handler.quantize, 'walk': walk.steps,
            'launches': launches,
            'memory_encoder_calls': log.memory_encoder_calls,
            'teacher_forced_forwards': log.forwards,
            'ready_seconds': ready,
            'demotions': decode.get('demotions', [])}


def segmem_worst_case(torch):
    """One chained decode on fused_bf16 at the serving shape: 8 chains x 8
    segments x 1024 steps of the paper's model at bf16 (seed-0 random
    weights rarely emit EOS); and the memory encoder alone at B = 8."""
    phase('segment-memory worst case (fused_bf16, 8 chains x 8 segments '
          'x 1024 steps)')
    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.ops import decode
    from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params

    handler = serve.build_handler(SEGMEM_ARGS)
    model, cfg = handler.model, handler.cfg
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(4)
    mel = torch.rand((8, 8, 256, cfg.mel_bins), generator=gen).to(dev)
    dp = stack_decode_params(model, quantize='fused_bf16')
    decode.segmem_greedy_decode(model, mel[:, :1], 32,
                                quantize='fused_bf16', dp=dp)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    toks = decode.segmem_greedy_decode(model, mel, 1024,
                                       quantize='fused_bf16', dp=dp)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    toks = toks.cpu()
    if toks.shape != (8, 8, 1025) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        fail(f'segmem worst case: bad tokens {tuple(toks.shape)}')
    steps = int((toks[..., 1:] != cfg.pad_token_id).sum(-1).amax(0).sum())
    mem = toks[:, 0, :1024].to(dev)
    with torch.no_grad():
        mem_ms = time_ms(torch, lambda: model.compute_segmem(mem))
    audio_s = 8 * 8 * 256 * 128 / 16000
    out = {'seconds': secs, 'steps': steps,
           'ms_per_step': secs / max(steps, 1) * 1e3, 'rtf': audio_s / secs,
           'memory_encoder_ms_per_segment': mem_ms}
    print(f'fused_bf16 chains: {secs:.3f} s for {steps} sequential steps '
          f'(8 segments), {out["ms_per_step"]:.4f} ms/step, realtime '
          f'factor {out["rtf"]:.2f}; memory encoder {mem_ms:.4f} ms per '
          f'segment (B=8, L=1024)')
    return out


def main():
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false')
    if not os.path.isdir(os.path.join(REPO, 'mr_mt3_tpu_torch')):
        fail('mr_mt3_tpu_torch/ is not beside this script')
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    environment(torch)
    build_kernels()
    cases = kernel_cases(torch)
    attn_cases = attention_cases(torch)
    parity = parity_on_card(torch)
    parity['segmem'] = segmem_parity_on_card(torch)
    main = main_path(torch)
    segmem = segmem_main_path(torch)
    launches = held_tier_serving(torch)
    worst = worst_case(torch)
    worst['segmem_fused_bf16'] = segmem_worst_case(torch)

    notes = {'library_note': 'no single PyTorch call computes a greedy '
                             'window'}
    kernels = []
    for tier in TIERS:
        main_case = next(c for c in cases[tier] if c['batch'] == 8
                         and c['pos0'] == 992 and c['lenc'] == 256)
        kernels.append({
            'name': f'fused_decode_window[{tier}]', 'mode': tier,
            'route': 'cuda',
            'source': 'mr_mt3_tpu_torch/csrc/fused_decode_window.cu',
            'replaces': 'mr_mt3_tpu/ops/fused_decode.py:969',
            'launches': launches[tier],
            'max_abs_err': max(c['max_abs_err'] for c in cases[tier]),
            'ms': main_case['ms'], 'plain_ms': main_case['plain_ms'],
            'bound_ms': main_case['bound_ms'],
            'bound_by': main_case['bound_by'],
            'library_ms': None, **notes,
            'main_path_launches': main['launches'][tier],
            'segmem_path_launches': segmem['launches'][tier],
            'cases': cases[tier]})
    enc = next(c for c in attn_cases if c['case'] == 'memory_encoder_b8')
    kernels.append({
        'name': 'fused_attention_fwd', 'route': 'cuda',
        'source': 'mr_mt3_tpu_torch/csrc/fused_attention_fwd.cu',
        'replaces': 'mr_mt3_tpu/ops/train_attention.py:185',
        'launches': segmem['launches']['fused_attention_fwd'],
        'max_abs_err': max(c['max_abs_err'] for c in attn_cases),
        'ms': enc['ms'], 'plain_ms': enc['plain_ms'],
        'bound_ms': enc['bound_ms'], 'bound_by': enc['bound_by'],
        'library_ms': enc['library_ms'],
        'library_note': 'torch.nn.functional.scaled_dot_product_attention, '
                        'scale 1.0, timed only',
        'cases': attn_cases})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_kernels.json'), 'w') as f:
        json.dump({'card': card_line(), 'kernels': kernels,
                   'parity': parity, 'main_path': main,
                   'segmem_main_path': segmem,
                   'worst_case': worst}, f, indent=1)
    print(json.dumps({'kernels': kernels}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
