"""The highest rate an open-loop cell's system sustains: windows of the
cell's length at each rate, repeated on other seeds, on the card, in one
process, reporting the latency percentiles and whether the backlog grew
(the last third of the requests' median latency over 1.5 times the first
third's). The knee is the highest rate at which no repeat grew; the rate
fixed in a traffic mix is set from it once, at about four fifths. Not run
by the benchmark's runs.

  python3 perfbench/sweep.py --workload mt3.clips-open
      --rates 2 2.25 2.5 2.75 3 --repeats 2 --seed 7
"""

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, '.cache', 'triton')
os.environ['CUDA_CACHE_PATH'] = os.path.join(ROOT, '.cache', 'nv')
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, default=None,
                    help='the window (default: run_seconds)')
    ap.add_argument('--rates', type=float, nargs='+', required=True)
    ap.add_argument('--repeats', type=int, default=2)
    ap.add_argument('--seed', type=int, default=7)
    args = ap.parse_args()

    from perfbench import core
    seconds = args.seconds or float(core.manifest()['run_seconds'])
    for rate, rep in [(r, k) for k in range(args.repeats)
                      for r in args.rates]:
        res = core.run(args.workload, args.seed + rep, seconds, False,
                       mix_patch={'rate_per_s': rate}, compare=False)
        lat = res['latencies']
        third = max(1, len(lat) // 3)
        first = statistics.median(lat[:third])
        last = statistics.median(lat[-third:])
        q = statistics.quantiles(lat, n=20)
        print(json.dumps({'rate_per_s': rate, 'repeat': rep,
                          'seed': args.seed + rep, 'requests': len(lat),
                          'failed': res['failed'], 'p50_s': q[9],
                          'p95_s': q[18], 'max_s': max(lat),
                          'first_third_median_s': first,
                          'last_third_median_s': last,
                          'backlog_grew': last > 1.5 * first}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
