#!/usr/bin/env python3
"""Probe behind PERF.md's per-phase readings of the decoder megakernels.
Run from the repository root on a machine with one NVIDIA card:

    python3 probes/decode_phases.py

Builds the fused_decode_step and fused_decode_window libraries with
ops/cuda_build's flags and -DPHASE_TRACE (block 0 stamps %globaltimer as
it leaves each grid barrier, and the step's first self-attention pair at
the boundaries of attend_chunks' sub-phases), then launches, through the
port's wrappers on those builds, the step at B 8 and 64, position 1023, in
each mode and the grouped int8 window at G 8, pos0 0 and 992 (full width,
seeded random weights and caches, as chip_smoke.py's cases). Per phase
(qkv, self, wo, wqc, cross, woc, ffin, ffout, lm, argmax) it prints the
median and largest microseconds over the layers (and steps), and the
step's self-attention sub-phases: q and the split's scales to the scores,
the chunk maxima and their exchange, exp(s - M_c) and the per-chunk sums,
the codes, the value sums, the combination of the two splits, the f32
diagonal term. One JSON line a reading; writes only its builds
(probes/_build/, git-ignored)."""

import ctypes
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mr_mt3_tpu_torch.ops import cuda_build  # noqa: E402
from mr_mt3_tpu_torch.ops import fused_decode as fd  # noqa: E402
from mr_mt3_tpu_torch.ops import group_axis_kernel as gk  # noqa: E402

BUILD = os.path.join(REPO, 'probes', '_build')
PHASES = ('qkv', 'self', 'wo', 'wqc', 'cross', 'woc', 'ffin', 'ffout')
SUB_PHASES = ('scores', 'chunk maxima', 'exp and sums', 'codes', 'values',
              'combine', 'diagonal')
SUB_BASE = 2048          # csrc: ASTAMP's slots in g_phase_ns
STAMPS = 4096            # csrc: PHASE_TRACE_MAX


def build(name):
    try:
        path, _ = cuda_build.build(
            name, flags=('-DPHASE_TRACE',),
            out=os.path.join(BUILD, f'lib{name}_phases.so'))
    except RuntimeError as e:
        sys.exit(str(e))
    lib = ctypes.CDLL(str(path))
    prefix, entries = fd._LIBRARIES[name]
    for entry in entries:
        getattr(lib, entry).argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
    getattr(lib, prefix + '_error_string').restype = ctypes.c_char_p
    return lib


def main():
    if not torch.cuda.is_available():
        sys.exit('no CUDA card')
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params
    from mr_mt3_tpu_torch.utils.builders import init_params
    libs = {n: build(n) for n in ('fused_decode_step', 'fused_decode_window')}

    def launch(name, entry, label, tensors, dims, eps, dev):
        lib = libs[name]
        prefix = fd._LIBRARIES[name][0]
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[None if t is None else t.data_ptr() for t in tensors])
        rc = getattr(lib, entry)(ptrs, (ctypes.c_int * len(dims))(*dims),
                                 eps, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f'{label}: '
                               + getattr(lib, prefix + '_error_string')(rc)
                               .decode())
    fd._launch = launch

    def stamps(name, reader, fn):
        fn()
        fn()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * STAMPS)()
        rc = getattr(libs[name], reader)(buf, STAMPS)
        if rc:
            sys.exit(f'reading the stamps failed ({rc})')
        return list(buf)

    def report(label, ns, seq, sub=False):
        agg = {}
        for j, phase in enumerate(seq):
            agg.setdefault(phase, []).append((ns[j + 1] - ns[j]) / 1e3)
        out = {'case': label, 'total_us': (ns[len(seq)] - ns[0]) / 1e3,
               'phases_us': {p: {'median': statistics.median(v),
                                 'max': max(v), 'n': len(v)}
                             for p, v in agg.items()}}
        s = ns[SUB_BASE:SUB_BASE + len(SUB_PHASES) + 1]
        if sub and all(s):
            out['self_attention_first_pair_us'] = {
                p: (s[k + 1] - s[k]) / 1e3 for k, p in enumerate(SUB_PHASES)}
        print(json.dumps(out), flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    cfg = MT3Config()
    dev = torch.device('cuda')
    model = init_params(MT3(cfg), seed=0).to(dev).eval()
    gen = torch.Generator().manual_seed(9)
    cache_gen = torch.Generator(device=dev).manual_seed(10)
    L, T = cfg.num_decoder_layers, fd.FUSED_WINDOW
    for tier in chip_smoke.TIERS:
        dp = stack_decode_params(model, quantize=tier)
        for batch in (8, 64):
            enc = (torch.randn((batch, 256, cfg.d_model), generator=gen)
                   * 0.5).to(dev)
            cross = fd.precompute_cross_kv_fused(dp, cfg, enc)
            cache = chip_smoke.seeded_cache(torch, fd, cfg, batch, tier,
                                            cache_gen)
            tokens = torch.randint(3, cfg.vocab_size, (batch,),
                                   generator=gen).to(dev)
            x = dp.token_embed[tokens].float() + dp.pos_table[1023].float()
            args = (cfg, dp.fused, x, 1023, cache, cross,
                    fd.cache_chunk(cache, cross))
            # above 8 rows the step runs ft_kernel, in its own unit
            ns = stamps('fused_decode_step', 'fds_phase_trace' if batch <= 8
                        else 'fds_tiles_phase_trace',
                        lambda: fd.fused_decode_step_cuda(*args))
            report(f'step {tier} B={batch} position=1023', ns,
                   list(PHASES) * L + ['lm'], sub=True)
        if tier != 'fused':
            continue
        for pos0 in (0, 992):
            groups = 8
            batch = 8 * groups
            enc = (torch.randn((batch, 256, cfg.d_model), generator=gen)
                   * 0.5).to(dev)
            cross = gk.regroup_cross_kv(
                fd.precompute_cross_kv_fused(dp, cfg, enc), groups)
            cache = gk.init_fused_cache_grouped(cfg, groups, 1024, dev)
            tokens = torch.randint(3, cfg.vocab_size, (batch,),
                                   generator=gen, dtype=torch.int32).to(dev)
            finished = torch.zeros(batch, dtype=torch.bool, device=dev)
            args = (cfg, dp.fused, fd.window_pos_rows(dp, pos0, T), tokens,
                    finished, pos0, cache, cross, T,
                    chip_smoke.GROUPED_CHUNK)
            ns = stamps('fused_decode_window', 'fdw_grouped_phase_trace',
                        lambda: gk.fused_decode_window_grouped_cuda(*args))
            seq = (['init'] + (list(PHASES) * L + ['lm', 'argmax']) * T)[:-1]
            report(f'grouped G={groups} pos0={pos0}', ns, seq)


if __name__ == '__main__':
    main()
