#!/usr/bin/env python3
"""The step-by-step decode loop's time per step, this tree's against
another's. Run from the repository root on a machine with one NVIDIA card:

    python3 probes/step_loop.py [TREE]

TREE is a directory holding another checkout's mr_mt3_tpu_torch (default:
this repository), for example the parent commit unpacked with
`git archive <commit> mr_mt3_tpu_torch | tar -x -C .archive/parent`. For
each step-by-step tier ('none' at fp32 with TF32 off, 'int8', 'int8_kv')
at full width (MT3Config(), seed-0 random weights, B=8 rows of random
mel): the device's busy ms per step over steps 8-39 (decodes of 8 and 40
steps under torch.profiler, differenced: chip_smoke.device_per_step) and
the wall ms per step of a 256-step decode, eagerly and, where the tree has
them, from replayed CUDA graphs; for the graphed loop also the host ms of
one replay() call of an 8-step block (the launch of its graph, which the
loop waits for after each block's exit check) and the block's device ms
(CUDA events). Prints one JSON line a reading, each with the card's name
and power limit."""

import importlib.util
import inspect
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else REPO
sys.path.insert(0, TREE)

import torch  # noqa: E402

from mr_mt3_tpu_torch.models import MT3, MT3Config  # noqa: E402
from mr_mt3_tpu_torch.ops import decode  # noqa: E402
from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params  # noqa: E402
from mr_mt3_tpu_torch.utils.builders import init_params  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    'chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

STEPS = 256


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    cfg = MT3Config()
    dev = torch.device('cuda')
    model = init_params(MT3(cfg), seed=0).to(dev).eval()
    mel = torch.rand((8, 256, cfg.mel_bins),
                     generator=torch.Generator().manual_seed(2)).to(dev)
    has_graphs = 'graphs' in inspect.signature(
        decode.greedy_decode).parameters
    ways = (False, None) if has_graphs else ('eager',)
    for tier in ('none', 'int8', 'int8_kv'):
        dp = stack_decode_params(model, quantize=tier)
        for graphs in ways:
            kw = {} if graphs == 'eager' else {'graphs': graphs}

            def run(n):
                return decode.greedy_decode(model, mel, n, quantize=tier,
                                            dp=dp, **kw)
            for n in (*chip_smoke.PROFILE_STEPS, STEPS):
                run(n)              # builds, and captures every block
            torch.cuda.synchronize()
            t0 = time.monotonic()
            toks = run(STEPS)
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            steps = int((toks[:, 1:] != cfg.pad_token_id).sum(1).max())
            row = {'tree': os.path.relpath(TREE, REPO), 'tier': tier,
                   'way': 'graphed' if graphs is None else 'eager',
                   'steps': steps, 'ms_per_step': secs / steps * 1e3,
                   'card': card}
            row.update(chip_smoke.device_per_step(torch, run,
                                                  row['ms_per_step']))
            if graphs is None:
                row.update(replay_readings(torch, dp))
            print(json.dumps(row), flush=True)


def replay_readings(torch, dp):
    """Host ms of one replay() call of the last phase's 8-step block of
    the 256-step runner, and the block's device ms, medians of 20."""
    runner = next(r for r in dp.runners.values()
                  if r.max_length == STEPS)
    graph = runner.graphs[(STEPS, 8)][0]
    host, device = [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(20):
        runner.step_index.fill_(STEPS - 8)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        graph.replay()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end))
    return {'replay_host_ms': statistics.median(host),
            'block_device_ms': statistics.median(device)}


if __name__ == '__main__':
    main()
