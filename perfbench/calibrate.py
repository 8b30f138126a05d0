"""The readings a configuration's limit is set from, in one process on the
card: for each seed a run of the cell (its own load, a short window), the
program's widest logit gap under the reference, and for the first
--control seeds the control's (the reference one precision step below the
configuration's). Not run by the benchmark's runs.

  python3 perfbench/calibrate.py --workload <cell> --seconds 10
      --seeds 11 12 ... --control 3

One JSON line a seed on standard output; a summary last.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, '.cache', 'triton')
os.environ['CUDA_CACHE_PATH'] = os.path.join(ROOT, '.cache', 'nv')
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, default=10.0)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--control', type=int, default=3)
    args = ap.parse_args()

    import torch

    from perfbench import core
    if not torch.cuda.is_available():
        print('calibrate needs a CUDA card', file=sys.stderr)
        return 2
    program, control = {}, {}
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        res = core.run(args.workload, seed, args.seconds, False,
                       control=i < args.control)
        r = res['readings']
        for k, v in r.items():
            if k.startswith('control_'):
                control.setdefault(k[len('control_'):], []).append(v)
            elif k not in ('steps', 'segments'):
                program.setdefault(k, []).append(v)
        print(json.dumps({'seed': seed, 'failed': res['failed'],
                          'attempted': res['attempted'],
                          'seconds': time.perf_counter() - t0, **r}),
              flush=True)
    print(json.dumps({
        'workload': args.workload,
        'program_max': {k: max(v) for k, v in program.items()},
        'control_min': {k: min(v) for k, v in control.items()},
        'program': program, 'control': control}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
