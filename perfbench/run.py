"""Run one cell of BENCHMARK.json once and print its result line.

  python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
      --trace <0|1>

--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics from a torch.profiler trace of the same window. The last line of
standard output is the result; the numbers compared with the reference,
each beside its limit, are the last lines of standard error. The run needs
a CUDA card and fails without one.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel caches inside the checkout, at fixed paths (the program builds
# its CUDA libraries into mr_mt3_tpu_torch/_build/ there itself)
os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, '.cache', 'triton')
os.environ['CUDA_CACHE_PATH'] = os.path.join(ROOT, '.cache', 'nv')
os.environ['USE_FLAX'] = '0'
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from perfbench import core
    bench = core.manifest()
    cell = core.cell_parts(bench, args.workload)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell['chips']):
        print(f'{args.workload} needs {cell["chips"]} CUDA card(s); '
              f'this machine has '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    result = core.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device='cuda', t_start=T_START,
                      bench=bench)
    bad = core.forbidden_modules()
    if bad:
        print(f'the run loaded {", ".join(bad)}: the benchmark measures '
              f'the PyTorch port alone', file=sys.stderr)
        return 3
    core.print_result(result)
    return 0


if __name__ == '__main__':
    sys.exit(main())
