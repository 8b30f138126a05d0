#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (mr_mt3_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. environment: card name and power limit, torch / CUDA / nvcc versions;
  2. build: every kernel of the main path from csrc/ (nvcc, one process per
     source, started together);
  3. kernels against their plain PyTorch versions on the card at full
     width (MT3Config(), seeded weights and encoder states, Lenc 256):
     B in {8, 64} x pos0 in {0, 32, 992}, the cache rows < pos0 decoded
     by the kernel itself; K/V rows and last-step logits within tolerance;
     tokens equal up to a first divergence that is only allowed where the
     plain version scores the two tokens nearly alike; CUDA-event timings
     (median of 20) beside the bytes/operations bound;
  4. main path: the handler exactly as `python -m mr_mt3_tpu_torch.serve`
     builds it (configs/config.yaml, model=MT3Net, seeded random weights,
     quantize fused_bf16), prewarmed, serving WAV clips over HTTP from two
     concurrent clients; launch counts are zeroed just before and read
     just after, and must cover every window the decoded tokens needed;
  5. one worst-case decode (B=8, 1024 steps) on fused_bf16 and on the exact
     path (fp32, TF32 off);
then one JSON line of kernel numbers, the card line, and the result line.
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

# Kernel vs plain version. Both sum in f32 but in different orders, so a
# bf16-rounded activation may land one bf16 ulp (2^-8 relative) apart;
# such flips pass from layer to layer (a flipped input moves every output
# of the next projection a little, which flips some of its roundings), and
# the unscaled attention over up to 1024 cache rows amplifies them. So:
#   * K/V rows within KV_RTOL of the largest |row| of the compared steps;
#   * last-step logits of rows whose tokens agree within LOGIT_RTOL of the
#     largest |logit|;
#   * a row's tokens may diverge only at a step where the plain version
#     scores the two chosen tokens within 2 x LOGIT_RTOL of each other
#     (each of the two scores may be off by LOGIT_RTOL).
# On the H100 at full width the kernel stays within 2.2e-2 (K/V) and
# 1.6e-2 (logits) of the plain version (PERF.md, H100 port section).
KV_RTOL = 4e-2
LOGIT_RTOL = 3e-2
TIMED_RUNS = 20


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


def window_bound_ms(cfg, batch, pos0, lenc, t_window):
    """Least time for one window as a function: each input byte read once
    (only the cache rows < pos0 and the embedding rows the window uses),
    each output byte written once, against HBM bandwidth; and its
    multiply-adds at the bf16 tensor-core peak. Returns (ms, bound_by)."""
    L, H, dk, D = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv, cfg.d_model
    inner, F, V = cfg.inner_dim, cfg.d_ff, cfg.vocab_size
    per_layer = D * 3 * inner + inner * D + D * inner + inner * D \
        + D * 2 * F + F * D
    weights = 2 * (L * per_layer + D * V) + 4 * (L * 3 * D + D)
    read = (weights + 2 * t_window * batch * D + 4 * t_window * D
            + 2 * 2 * L * H * batch * dk * lenc
            + 2 * 2 * L * H * batch * dk * pos0 + 8 * batch)
    written = 4 * t_window * batch + 4 * batch \
        + 2 * 2 * t_window * L * H * batch * dk
    flops = t_window * 2 * batch * (L * per_layer + D * V)
    for t in range(t_window):
        rows = pos0 + t + 1
        flops += L * batch * H * 2 * 2 * dk * (rows + lenc)
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS
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


def compare_window(torch, cfg, got, want, logits, last_logits):
    """Per batch row: tokens equal up to a first divergence, allowed only
    where the plain version scores the two chosen tokens nearly alike; K/V
    rows compared up to that step; last-step logits compared for rows
    whose tokens all agree. Returns a dict of the errors."""
    toks_k, fin_k, kw_k, vw_k = (t.cpu() for t in got)
    toks_p, fin_p, kw_p, vw_p = (t.cpu() for t in want)
    logits, last_logits = logits.cpu(), last_logits.cpu()
    T, B = toks_p.shape
    L, H = cfg.num_decoder_layers, cfg.num_heads
    diverged = []
    kv_err, kv_scale, logit_err, logit_scale = 0.0, 0.0, 0.0, 0.0
    max_gap = 0.0
    for b in range(B):
        diff = (toks_k[:, b] != toks_p[:, b]).nonzero()
        last = T - 1
        if len(diff):
            d = int(diff[0])
            row = logits[d, b]
            scale = float(row.abs().max())
            gap = float(row[toks_p[d, b]] - row[toks_k[d, b]])
            max_gap = max(max_gap, gap / scale)
            bound = 2 * LOGIT_RTOL * scale
            if gap >= bound:
                fail(f'row {b} token diverges at step {d}: the plain '
                     f'version scores its token {gap:.4g} above the '
                     f"kernel's (bound {bound:.4g})")
            diverged.append((b, d))
            last = d
        else:
            if not torch.equal(fin_k[b], fin_p[b]):
                fail(f'row {b}: finished flags differ with equal tokens')
            logit_err = max(logit_err, float(
                (last_logits[b] - logits[T - 1, b]).abs().max()))
            logit_scale = max(logit_scale,
                              float(logits[T - 1, b].abs().max()))
        for kk, pp in ((kw_k, kw_p), (vw_k, vw_p)):
            a = kk[:last + 1].reshape(last + 1, L, H, B, -1)[:, :, :, b]
            r = pp[:last + 1].reshape(last + 1, L, H, B, -1)[:, :, :, b]
            kv_err = max(kv_err, float((a.float() - r.float()).abs().max()))
            kv_scale = max(kv_scale, float(r.float().abs().max()))
    if not kv_err <= KV_RTOL * kv_scale:
        fail(f'K/V rows differ by {kv_err:.4g} > {KV_RTOL} x {kv_scale:.4g}')
    if not logit_err <= LOGIT_RTOL * logit_scale:
        fail(f'last-step logits differ by {logit_err:.4g} > {LOGIT_RTOL} x '
             f'{logit_scale:.4g}')
    return {'max_abs_err': kv_err, 'kv_rel_err': kv_err / kv_scale,
            'logit_rel_err': logit_err / max(logit_scale, 1e-30),
            'rows_diverged': len(diverged), 'max_gap_rel': max_gap}


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
    dp = stack_decode_params(model, quantize='fused_bf16')
    fp = dp.fused
    lenc, T = 256, fd.FUSED_WINDOW
    cases = [(b, p) for b in (8, 64) for p in (0, 32, 992)]
    results = []
    gen = torch.Generator().manual_seed(1)
    for batch, pos0 in cases:
        enc = (torch.randn((batch, lenc, cfg.d_model), generator=gen)
               * 0.5).to(dev)
        cross = fd.precompute_cross_kv_fused(dp, cfg, enc)
        cache = fd.init_fused_cache(cfg, batch, 1024, dev)
        tokens = torch.randint(3, cfg.vocab_size, (batch,), generator=gen,
                               dtype=torch.int32).to(dev)
        finished = torch.zeros(batch, dtype=torch.bool, device=dev)
        # rows < pos0 hold what a decode leaves there: decode up to pos0
        # with the kernel itself (chained windows)
        for p in range(0, pos0, T):
            toks_w, finished, cache = fd.fused_decode_window(
                cfg, fp, dp, tokens, finished, p, cache, cross, T)
            tokens = toks_w[:, -1].contiguous()
        finished = finished.clone()
        finished[batch - 1] = True          # a finished row must emit pad
        pos_rows = fd.window_pos_rows(dp, pos0, T)
        args = (cfg, fp, pos_rows, tokens, finished, pos0, cache, cross, T)
        last_logits = torch.empty((batch, cfg.vocab_size), device=dev)
        got = fd.fused_decode_window_cuda(*args, logits_out=last_logits)
        torch.cuda.synchronize()
        want = fd.fused_decode_window_reference(*args, return_logits=True)
        if not bool((got[0][:, batch - 1] == cfg.pad_token_id).all()):
            fail('a finished row emitted a non-pad token')
        errs = compare_window(torch, cfg, got, want[:4], want[4],
                              last_logits)
        ms = time_ms(torch, lambda: fd.fused_decode_window_cuda(*args))
        plain_ms = time_ms(torch,
                           lambda: fd.fused_decode_window_reference(*args))
        bound, bound_by = window_bound_ms(cfg, batch, pos0, lenc, T)
        case = {'batch': batch, 'pos0': pos0, **errs, 'ms': ms,
                'plain_ms': plain_ms, 'bound_ms': bound,
                'bound_by': bound_by}
        print(json.dumps(case), flush=True)
        results.append(case)
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


def main_path(torch):
    """Serve WAV clips through the port's HTTP server on fused_bf16."""
    phase('main path: python -m mr_mt3_tpu_torch.serve equivalent')
    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.ops import fused_decode as fd

    fd.LAUNCHES = 0
    t0 = time.monotonic()
    handler = serve.build_handler([])
    if handler.quantize != 'fused_bf16':
        fail(f'serving tier is {handler.quantize!r}, expected fused_bf16')
    # keep every decode's tokens (the prewarm's too), to work out how many
    # windows the kernel had to run for them
    decoded = []
    decode_all = handler._decode_all

    def recording_decode_all(mel):
        tokens = decode_all(mel)
        decoded.append(tokens)
        return tokens

    handler._decode_all = recording_decode_all
    info = serve.prepare_handler(handler)
    print(f'handler built and prewarmed in {time.monotonic() - t0:.1f} s')
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
    launches = fd.LAUNCHES
    for seconds, seed in clips:
        if seed not in replies:
            fail(f'no reply for the {seconds} s clip')
        status, body, secs = replies[seed]
        if status != 200 or body[:4] != b'MThd':
            fail(f'{seconds} s clip: HTTP {status}, body {body[:16]!r}')
        print(f'clip {seconds} s -> {len(body)} MIDI bytes in {secs:.2f} s')
    if health['decode'].get('quantize') != 'fused_bf16' or \
            not health['decode'].get('prewarmed'):
        fail(f'/healthz decode info: {health["decode"]}')
    print(f'healthz: {json.dumps(health)}')
    batch = min(handler.batch_size, fd.FUSED_MAX_BATCH)
    calls = windows = 0
    for tokens in decoded:
        c, w = windows_needed(tokens, batch, handler.max_length,
                              handler.cfg.eos_token_id, fd.FUSED_WINDOW)
        calls, windows = calls + c, windows + w
    print(f'{len(clips)} requests in {wall:.2f} s wall, {launches} window '
          f'launches for {windows} windows over {calls} decode calls '
          f'({len(decoded)} transcribe batches, the prewarm included)')
    if len(decoded) != health['batches'] + 1:
        fail(f'{len(decoded)} decodes recorded for {health["batches"]} '
             f'request batches and the prewarm')
    if windows < calls or launches < windows:
        fail(f'{launches} kernel launches for {windows} windows decoded')
    return launches


def worst_case(torch):
    """B=8, 1024-step decode, fused_bf16 and the exact fp32 path."""
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
    out = {}
    for tier in ('fused_bf16', 'none'):
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
        print(f'{tier}: {secs:.3f} s, {steps} steps decoded, '
              f'{secs / max(steps, 1) * 1e3:.4f} ms/step, '
              f'realtime factor {audio_s / secs:.2f}')
    agree = float((out['fused_bf16'] == out['none']).float().mean())
    print(f'fused_bf16 vs exact token agreement: {agree:.4f}')


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
    launches = main_path(torch)
    worst_case(torch)

    main_case = next(c for c in cases if c['batch'] == 8
                     and c['pos0'] == 992)
    kernels = [{
        'name': 'fused_decode_window', 'mode': 'fused_bf16',
        'route': 'cuda',
        'source': 'mr_mt3_tpu_torch/csrc/fused_decode_window.cu',
        'replaces': 'mr_mt3_tpu/ops/fused_decode.py:969',
        'launches': launches,
        'max_abs_err': max(c['max_abs_err'] for c in cases),
        'ms': main_case['ms'], 'plain_ms': main_case['plain_ms'],
        'bound_ms': main_case['bound_ms'],
        'bound_by': main_case['bound_by'],
        'library_ms': None,
        'library_note': 'no single PyTorch call computes a greedy window',
        'cases': cases}]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_kernels.json'), 'w') as f:
        json.dump({'card': card_line(), 'kernels': kernels}, f, indent=1)
    print(json.dumps({'kernels': kernels}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
