#!/usr/bin/env python3
"""The model axis's collectives between two gloo ranks sharing one card.
Run from the repository root on a machine with an NVIDIA card:

    python3 probes/tp_collectives.py

Starts two ranks (this script again, with a rank argument) on a file store;
each times, over 200 calls after 20 of warm-up, the collectives a
tensor-parallel decode step makes at full width and B=8 (an all-reduce of
(8, 1, 512) and an all-gather of (8, 768), float32) and a training step's
all-reduce of (2, 1024, 512): on the card tensors themselves (gloo stages
them through the host), on CPU tensors (gloo's own path), and through an
explicit copy to the CPU and back. Rank 0 prints one JSON line a reading
(median and quartiles in ms) and the card's name and power limit."""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 200
WARMUP = 20
SHAPES = {'decode_all_reduce': (8, 1, 512), 'train_all_reduce': (2, 1024, 512)}


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True).stdout


def timed(torch, fn):
    ms = []
    for i in range(WARMUP + CALLS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= WARMUP:
            ms.append((time.perf_counter() - t0) * 1e3)
    q = statistics.quantiles(ms, n=4)
    return {'median_ms': statistics.median(ms), 'q1_ms': q[0],
            'q3_ms': q[2]}


def rank_main(rank, store):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method=f'file://{store}',
                            world_size=2, rank=rank)
    group = dist.new_group([0, 1])
    dev = torch.device('cuda', 0)
    out = []
    for name, shape in SHAPES.items():
        x = torch.randn(shape, device=dev)
        cpu = x.cpu()

        def on_card():
            dist.all_reduce(x, group=group)

        def on_cpu():
            dist.all_reduce(cpu, group=group)

        def staged():
            y = x.cpu()
            dist.all_reduce(y, group=group)
            x.copy_(y.to(dev))
        for route, fn in (('card_tensor', on_card), ('cpu_tensor', on_cpu),
                          ('staged', staged)):
            dist.barrier(group)
            out.append({'collective': name, 'shape': list(shape),
                        'route': route, **timed(torch, fn)})
    logits = torch.randn((8, 768), device=dev)
    parts = [torch.empty_like(logits) for _ in range(2)]
    dist.barrier(group)
    out.append({'collective': 'decode_all_gather', 'shape': [8, 768],
                'route': 'card_tensor',
                **timed(torch, lambda: dist.all_gather(parts, logits,
                                                       group=group))})
    if rank == 0:
        card = card_line().strip()
        for row in out:
            print(json.dumps({**row, 'card': card}), flush=True)
    dist.barrier(group)
    dist.destroy_process_group()


def main():
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, 'store')
        procs = [subprocess.Popen([sys.executable, __file__, str(r), store],
                                  cwd=REPO) for r in range(2)]
        try:
            codes = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if any(codes):
        sys.exit(f'a rank failed: {codes}')


if __name__ == '__main__':
    if len(sys.argv) == 3:
        rank_main(int(sys.argv[1]), sys.argv[2])
    else:
        main()
