#!/usr/bin/env python3
"""Probes behind PERF.md's findings on the int8 attention kernel.
Run from the repository root on a machine with one NVIDIA card:

    python3 probes/int8_kernels.py

1. Micro-kernels (probes/int8_micro.cu, built with ops/cuda_build's
   flags): each variant's kernel time from a profiler trace, at 48 and
   384 blocks of 256 threads, so the difference to the minimal kernel is
   the cost of one building block: a block reduction, a cp.async round
   trip, a cluster barrier with its distributed stores, a dependent
   shared memory or L2 load.
2. The floors of csrc/int8_matmul.cu's int8_matmul at its grid, the
   lm_head (B x 512 @ 512 x 1536) at B 8 and 64: mm_floor's minimal
   kernel and its kernel that only reads the codes and writes B x N
   outputs, beside the int8_matmul kernel in f32 and bf16, each from a
   profiler trace, with the kernel's ratio to each floor.
3. The phases of csrc/int8_decode_attention.cu's one-block kernel: a copy
   of the source with clock64() stamps of thread 0 at its phase
   boundaries, built the same way; per-phase microseconds at 1.98 GHz,
   the median over the blocks of 9 launches, at B 8 x 6 heads of 64 over
   1024 and 256 positions.

Prints one JSON line a reading; writes only its builds (probes/_build/,
git-ignored)."""

import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from mr_mt3_tpu_torch.ops import cuda_build  # noqa: E402
from mr_mt3_tpu_torch.ops import int8_attention as i8a  # noqa: E402

BUILD = os.path.join(REPO, 'probes', '_build')
SM_HZ = 1.98e9          # the H100's SM clock under load (nvidia-smi)
# (text of the kernel, stamp index placed after it): thread 0's clock64
# at each phase boundary
STAMPS = [
    ('  copy_scales(vs, a.vs + bh * K, n, a.sw);\n', 1, 'issue loads'),
    ('  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n'
     '  __syncthreads();\n', 2, 'q to int8'),
    ('    if (npg <= pgp) load_rows(vq, PG_POS * pg);\n', 3, 'scores'),
    ('  const float m = __int_as_float(ordered(smax[0]));\n', 4,
     'partial sums and max'),
    ('  const float sum = block_reduce_once(ls, red[1], false);\n', 5,
     'exp and sum'),
    ('  const float ps = fmaxf(__int_as_float(smax[1]), 1e-20f) / 127.f;\n',
     6, 'p vs and its max'),
    ('  // 8. value sums', 7, 'codes'),
    ('  if (pgp >= 32) {', 8, 'value dots'),
    ('  T* out = static_cast<T*>(a.out) + bh * dk;\n', 9, 'value sums'),
]


def build(src, name):
    os.makedirs(BUILD, exist_ok=True)
    lib = os.path.join(BUILD, f'lib{name}.so')
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           '-o', lib, src], capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f'{src} does not build:\n{proc.stderr}')
    return ctypes.CDLL(lib)


def trace_us(fn, symbol, runs=20):
    """Median device time (us) of the `symbol` kernels of `runs` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and symbol in e.name]
    return statistics.median(us) if us else None


FLOOR_BATCHES = (8, 64)


def micro():
    lib = build(os.path.join(REPO, 'probes', 'int8_micro.cu'), 'int8_micro')
    lib.micro_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    dev = torch.device('cuda')
    q = torch.randn(384 * 256, device=dev)
    k = torch.randint(0, 100, (384 * 65536,), dtype=torch.int8, device=dev)
    o = torch.empty(384 * 256, device=dev)
    for blocks in (48, 384):
        for variant, smem, cluster in [(0, 0, 1), (1, 0, 1), (2, 1024, 1),
                                       (4, 0, 2), (4, 0, 8), (8, 4096, 1),
                                       (16, 0, 1)]:
            def run():
                rc = lib.micro_launch(q.data_ptr(), k.data_ptr(),
                                      o.data_ptr(), blocks, variant, smem,
                                      cluster,
                                      torch.cuda.current_stream().cuda_stream)
                if rc:
                    sys.exit(f'micro variant {variant} failed: {rc}')
            print(json.dumps({'micro': {'blocks': blocks, 'variant': variant,
                                        'cluster': cluster,
                                        'us': trace_us(run, 'micro')}}),
                  flush=True)
    return lib


def mm_grid(b, n, sms):
    """csrc/int8_matmul.cu's mm_grid at the lm_head's K (Q not cut by
    shared memory): (blocks, groups of 128 threads, rows a tile)."""
    rt = 8 if b <= 8 else 16
    tiles, units = -(-b // rt), -(-n // 16)
    grid = tiles * units if tiles * units <= sms else \
        tiles if tiles >= sms else sms // tiles * tiles
    return grid, min(4, -(-units // (grid // tiles))), rt


def floors(lib):
    """The int8_matmul kernel's floors at its grid (FLOOR_BATCHES)."""
    from mr_mt3_tpu_torch.ops import int8_matmul as i8m
    lib.mm_floor_launch.argtypes = [ctypes.c_void_p] * 2 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(5)
    k, n = 512, 1536
    codes, scale = i8m.quantize_columns(
        (torch.randn((k, n), generator=gen) * 0.05).to(dev))
    scale = scale[None].contiguous()
    for b in FLOOR_BATCHES:
        grid, q, rt = mm_grid(b, n, sms)
        out = torch.empty((b, n), device=dev)
        reading = {'batch': b, 'k': k, 'n': n, 'blocks': grid,
                   'threads': 128 * q}
        for read, name in ((0, 'minimal_us'), (1, 'read_codes_us')):
            def run(read=read):
                rc = lib.mm_floor_launch(
                    codes.data_ptr(), out.data_ptr(), b, k, n, rt, read,
                    grid, q, torch.cuda.current_stream().cuda_stream)
                if rc:
                    sys.exit(f'mm_floor failed: {rc}')
            reading[name] = trace_us(run, 'mm_floor')
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((b, k), generator=gen).to(dev, dtype)
            us = trace_us(lambda: i8m.int8_matmul(x, codes, scale),
                          'i8mm_kernel')
            name = str(dtype).split('.')[-1]
            reading[f'kernel_{name}_us'] = us
            reading[f'{name}_over_minimal'] = us / reading['minimal_us']
            reading[f'{name}_over_read_codes'] = \
                us / reading['read_codes_us']
        print(json.dumps({'int8_matmul_floors': reading}), flush=True)


def phases():
    src = open(os.path.join(cuda_build.CSRC_DIR,
                            'int8_decode_attention.cu')).read()
    src = src.replace('struct Args {\n', 'struct Args {\n  long long* st;\n',
                      1)
    head = '  const size_t bh = (size_t)b * a.H + h;\n'
    start = src.index('i8att_kernel(Args a) {')
    at = src.index(head, start) + len(head)
    src = src[:at] + (
        '  long long* st_ = a.st + ((size_t)blockIdx.y * gridDim.x + '
        'blockIdx.x) * 16;\n  const long long c0_ = clock64();\n') + src[at:]
    for text, i, _ in STAMPS:
        at = src.index(text, start)
        stamp = f'  if (threadIdx.x == 0) st_[{i}] = clock64() - c0_;\n'
        src = (src[:at] + stamp + src[at:] if text.startswith('  // 8.') or
               text.startswith('  if (pgp') else
               src[:at + len(text)] + stamp + src[at + len(text):])
    src = src.replace('  a.B = B; a.H = H;',
                      '  a.st = g_st;\n  a.B = B; a.H = H;')
    src = src.replace('extern "C" {', 'static long long* g_st;\nextern "C" {\n'
                      'void i8att_stamps(void* p) { g_st = (long long*)p; }', 1)
    os.makedirs(BUILD, exist_ok=True)
    path = os.path.join(BUILD, 'int8_attention_stamped.cu')
    open(path, 'w').write(src)
    lib = build(path, 'int8_attention_stamped')
    lib.i8att_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    lib.i8att_stamps.argtypes = [ctypes.c_void_p]
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(5)
    for b, h, dk, k_len, pos in [(8, 6, 64, 1024, 1023),
                                 (8, 6, 64, 256, 255)]:
        q = torch.randn((b, h, dk), generator=gen).to(dev)
        (kq, ks), (vq, vs) = (i8a.quantize_kv_rows(torch.randn(
            (b, h, dk, k_len), generator=gen).to(dev)) for _ in range(2))
        out = torch.empty((b, h * dk), device=dev)
        st = torch.zeros((b * h * 16,), dtype=torch.int64, device=dev)
        lib.i8att_stamps(st.data_ptr())
        runs = []
        for _ in range(9):
            st.zero_()
            rc = lib.i8att_launch(q.data_ptr(), kq.data_ptr(), ks.data_ptr(),
                                  vq.data_ptr(), vs.data_ptr(),
                                  out.data_ptr(), b, h, dk, k_len, pos, 0,
                                  torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if rc:
                sys.exit(f'stamped kernel failed: {rc}')
            runs.append(st.view(-1, 16)[:, 1:len(STAMPS) + 1].cpu().double())
        cum = torch.stack(runs).median(0).values.median(0).values
        prev, phase = 0.0, {}
        for (_, _, name), c in zip(STAMPS, cum.tolist()):
            phase[name] = round((c - prev) / SM_HZ * 1e6, 3)
            prev = c
        print(json.dumps({'phases': {'case': [b, h, dk, k_len, pos],
                                     'us': phase,
                                     'total_us': round(prev / SM_HZ * 1e6,
                                                       3)}}), flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA card')
    floors(micro())
    phases()


if __name__ == '__main__':
    main()
