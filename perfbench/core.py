"""One run of one cell: set-up, the measured window, the readings, the
comparison with the reference, the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in BENCHMARK.json:
perfbench/configs/<config>.json, perfbench/traffic/<traffic>.json and
perfbench/metrics/<metric>.py (a `read(ctx)` returning the value or None).
"""

from __future__ import annotations

import gc
import hashlib
import http.client
import importlib.util
import json
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from perfbench import trace, traffic
from perfbench.reference import frontend, judge, model

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mr_mt3_tpu')
# a run waits this long past the window's close for answers still due
DRAIN_S = 60.0
HTTP_TIMEOUT_S = 120.0


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, 'BENCHMARK.json'))


def cell_parts(bench: dict, name: str):
    """(cell, configuration file, traffic mix) of a workload name."""
    cells = {c['name']: c for c in bench['workloads']}
    if name not in cells:
        raise SystemExit(f'unknown workload {name!r}; known: '
                         f'{", ".join(cells)}')
    cell = cells[name]
    conf = {c['name']: c for c in bench['configs']}[cell['config']]
    config = load_json(os.path.join(ROOT, conf['file']))
    return cell, config, traffic.load(cell['traffic'])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: mr_mt3_tpu_torch is not mr_mt3_tpu)."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def steps_of(tokens: np.ndarray, eos: int) -> int:
    """Greedy steps a row decoded: through its first EOS, else all."""
    hit = np.nonzero(tokens[1:] == eos)[0]
    return int(hit[0]) + 1 if len(hit) else len(tokens) - 1


class Context:
    """What a per-layer metric's reader may read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def load_reader(name: str):
    path = os.path.join(HERE, 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        'perfbench_metric_' + name.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: dict, traced: bool) -> list:
    """The metrics this cell reports in this kind of run."""
    e2e = [m for m in bench['end_to_end']
           if cell['name'] in m.get('workloads', [cell['name']])]
    if not traced:
        return e2e
    names = {m['name'] for m in e2e}
    return [m for m in bench['per_layer']
            if cell['name'] in m.get('workloads', [cell['name']])
            or ('workloads' not in m and m['moves'] in names)]


# ---- the two kinds of traffic ----

def _post(port: int, body: bytes):
    conn = http.client.HTTPConnection('127.0.0.1', port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        conn.request('POST', '/transcribe', body=body,
                     headers={'Content-Type': 'audio/wav'})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status == 200 and len(data) > 0
    finally:
        conn.close()


def _healthz(port: int) -> dict:
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=30)
    try:
        conn.request('GET', '/healthz')
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def open_loop(port: int, bodies: list, due: np.ndarray, tracer):
    """Send each body at its due time (seconds after the start) from a
    thread of its own; returns per request (due, sent, done, ok) in host
    seconds, done = inf for a request that failed or never answered."""
    n = len(bodies)
    out = [None] * n
    pool = ThreadPoolExecutor(max_workers=256)

    def one(i, t_due):
        sent = time.perf_counter()
        try:
            with tracer.span('request'):
                ok = _post(port, bodies[i])
        except OSError:
            ok = False
        done = time.perf_counter()
        out[i] = (t_due, sent, done if ok else math.inf, ok)

    start = time.perf_counter() + 0.05
    futures = []
    for i in range(n):
        t_due = start + float(due[i])
        wait = t_due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        futures.append(pool.submit(one, i, t_due))
    deadline = start + float(due[-1]) + DRAIN_S
    for f in futures:
        try:
            f.result(timeout=max(1.0, deadline - time.perf_counter()))
        except TimeoutError:
            pass                  # never answered: counted as failed
    pool.shutdown(wait=True, cancel_futures=True)
    return start, [r if r is not None else (start + float(due[i]), math.inf,
                                            math.inf, False)
                   for i, r in enumerate(out)]


def closed_loop(prog, pool_audio: list, per_call: int, seconds: float,
                tracer):
    """transcribe_many calls back to back, `per_call` clips each from the
    pool in turn, none started after `seconds`; returns (start, calls:
    (t0, t1, clip indices, ok))."""
    calls, k = [], 0
    start = time.perf_counter()
    while time.perf_counter() < start + seconds:
        idx = [(k + j) % len(pool_audio) for j in range(per_call)]
        k += per_call
        t0 = time.perf_counter()
        try:
            with tracer.span('call'):
                prog.transcribe_many([pool_audio[i] for i in idx])
            ok = True
        except Exception as e:  # noqa: BLE001 -- counted as failed
            print(f'call failed: {e!r}', file=sys.stderr)
            ok = False
        calls.append((t0, time.perf_counter(), idx, ok))
    return start, calls


# ---- warm-up: the shapes this cell's traffic takes ----

def warm(prog, mix: dict, audio: list, lengths, port):
    """One transcribe_many call at each decode-call size the schedule
    takes, at full length, and for HTTP traffic one request through the
    server. A clip of one segment is one decode row, or one memory chain:
    k of them make a call of the bucket of k chains."""
    config = prog.config
    bs = int(mix['batch_size'])
    per_call = int(mix.get('songs_per_call', 1))
    clip = audio[0][:traffic.SEGMENT_SAMPLES - 64]
    if config['sizes'].get('segmem_length'):
        segs = [frontend.num_segments(int(n)) for n in lengths]
        calls = ([segs[i:i + per_call] for i in range(0, len(segs),
                                                       per_call)]
                 if mix['kind'] == 'closed_calls' else [[s] for s in segs])
        sizes = set()
        for call in calls:
            sizes.update(prog.call_sizes(sum(math.ceil(s / bs)
                                             for s in call)))
        for size in sorted(sizes):
            prog.transcribe_many([clip] * size)
    else:
        # vanilla: every decode call holds bs rows (the last padded)
        prog.transcribe_many([clip])
    if port is not None:
        _post(port, traffic.wav_bytes(clip))


# ---- the comparison ----

def sample_segments(config: dict, mix: dict, songs: list, seed: int,
                    audio_of) -> list:
    """A sample drawn from the seed of the finished songs' segments, the
    longest song in it: dicts for reference.judge."""
    sizes = config['sizes']
    budget = int(mix['judge_segments'])
    per_song = int(mix.get('judge_segments_per_song', budget))
    rng = np.random.default_rng([int(seed), 3])
    order = list(rng.permutation(len(songs)))
    longest = max(range(len(songs)), key=lambda i: len(songs[i]['tokens']))
    order.remove(longest)
    order.insert(0, longest)
    bs = int(mix['batch_size'])
    seed_mem = np.zeros(sizes['max_length'], np.int64)
    seed_ids = config.get('segmem_seed_ids', [])
    seed_mem[:len(seed_ids)] = seed_ids
    picked = []
    for i in order:
        if len(picked) >= budget:
            break
        song = songs[i]
        samples, valid = frontend.segments(audio_of(song))
        n = len(valid)
        if len(song['tokens']) != n:
            raise ValueError(f'a song of {n} segments came back with '
                             f'{len(song["tokens"])} token rows')
        take = min(n, per_song, budget - len(picked))
        idx = sorted({0, n - 1} | set(rng.choice(n, size=n, replace=False)
                                      [:max(0, take - 2)].tolist()))[:take]
        for j in idx:
            seg = {'samples': samples[j], 'valid': valid[j],
                   'tokens': np.asarray(song['tokens'][j], np.int64)}
            if sizes.get('segmem_length'):
                seg['memory'] = (np.asarray(song['tokens'][j - 1]
                                            [:sizes['max_length']], np.int64)
                                 if j % bs else seed_mem)
            picked.append(seg)
    return picked


# ---- one run ----

def run(workload: str, seed: int, seconds: float, traced: bool,
        device: str = 'cuda', t_start: float = None,
        config_patch: dict = None, mix_patch: dict = None,
        bench: dict = None, control: bool = False,
        compare: bool = True) -> dict:
    """Run one cell once; returns the result dict (the line's keys).
    control=True also reads the control (perfbench/calibrate.py);
    compare=False leaves the comparison out and returns the open loop's
    latencies in the order sent (perfbench/sweep.py)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = manifest() if bench is None else bench
    cell, config, mix = cell_parts(bench, workload)
    config = {**config, **(config_patch or {})}
    mix = {**mix, **(mix_patch or {})}
    sizes = config['sizes']
    cuda = device != 'cpu'
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from perfbench.program import Program
    lengths, due = traffic.schedule(mix, seed, seconds)
    audio = traffic.synthesize(lengths, seed, device)
    weights = model.make_weights(sizes, seed, device)
    tracer = trace.Tracer(traced)
    prog = Program(config, mix, weights, device, tracer)
    del weights
    port = prog.serve() if mix['kind'] == 'open_http' else None
    bodies = ([traffic.wav_bytes(a) for a in audio]
              if port is not None else None)
    warm(prog, mix, audio, lengths, port)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    build_s = prog.build_s
    print(f'set-up {setup_s:.3f} s, of which nvcc builds {build_s:.3f} s',
          file=sys.stderr)

    before = _healthz(port) if port is not None else None
    prog.rec.on = True
    with tracer.profiled():
        if port is not None:
            start, reqs = open_loop(port, bodies, due, tracer)
        else:
            start, calls = closed_loop(prog, audio,
                                       int(mix['songs_per_call']), seconds,
                                       tracer)
    prog.rec.on = False
    summary = tracer.summary
    after = _healthz(port) if port is not None else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    eos = config['eos_token_id']
    if port is not None:
        lat = sorted(done - d for d, _, done, _ in reqs)
        attempted, failed = len(reqs), sum(1 for r in reqs if not r[3])
        end = max((r[2] for r in reqs if r[3]), default=start)
        audio_s = float(sum(lengths)) / frontend.SAMPLE_RATE
        late = max((s - d for d, s, _, ok in reqs if ok), default=0.0)
        print(f'open loop: {attempted} requests, {failed} failed, the '
              f'generator at most {late:.4f} s late', file=sys.stderr)
    else:
        attempted = sum(len(c[2]) for c in calls)
        failed = sum(len(c[2]) for c in calls if not c[3])
        end = calls[-1][1]
        audio_s = float(sum(lengths[i] for c in calls for i in c[2]
                            if c[3])) / frontend.SAMPLE_RATE
        print(f'closed loop: {len(calls)} calls, {attempted} clips, '
              f'{failed} failed, {audio_s:.1f} audio s', file=sys.stderr)
    span_s = end - start

    metrics = {}
    wanted = cell_metrics(bench, cell, traced)
    if not traced:
        values = {'setup_s': setup_s,
                  'audio_s_per_s': audio_s / span_s if span_s > 0 else None}
        if port is not None:
            # the 99th percentile, nearest rank: at ~0.8 of the knee a
            # window's latencies fall on plateaus a decode call apart, and
            # the 95th sits on the edge between two (PERF.md section 2)
            k = max(0, math.ceil(0.99 * len(lat)) - 1)
            values['latency_p99_s'] = lat[k]
        for m in wanted:
            v = values.get(m['name'])
            if v is not None and math.isfinite(v):
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        ctx = Context(cell=cell, config=config, mix=mix, sizes=sizes,
                      calls=prog.rec.calls, songs=prog.rec.songs,
                      trace=summary, healthz=(before, after), eos=eos,
                      steps_of=steps_of)
        for m in wanted:
            v = load_reader(m['name'])(ctx)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}

    # the comparison, after the program's state is freed
    by_hash = {hashlib.sha1(a.tobytes()).hexdigest(): a for a in audio}

    def audio_of(song):
        key = hashlib.sha1(np.ascontiguousarray(
            song['audio'], np.float32).tobytes()).hexdigest()
        if key not in by_hash:
            raise ValueError('the program transcribed audio the run did '
                             'not send')
        return by_hash[key]

    if not compare:
        prog.close()
        return {'correct': False, 'attempted': attempted, 'failed': failed,
                'metrics': metrics,
                'latencies': [r[2] - r[0] for r in reqs] if port else []}
    songs = prog.rec.songs
    checks, problems = {}, []
    try:
        segs = sample_segments(config, mix, songs, seed, audio_of)
    except ValueError as e:
        segs, problems = [], [str(e)]
    prog.close()
    del prog, songs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = judge.judge(config, seed, segs, device, control=control) \
        if segs else {'max_logit_gap': math.inf, 'steps': 0}
    limit = config['limits']['max_logit_gap']
    if limit is None:
        problems.append('the configuration sets no limit')
        limit = -math.inf
    checks['max_logit_gap'] = {'value': verdict['max_logit_gap'],
                               'at_most': limit}
    checks['steps_compared'] = {'value': verdict['steps'],
                                'at_least': int(mix['judge_min_steps'])}
    checks['failed'] = {'value': failed, 'at_most': 0}
    correct = (not problems and failed == 0
               and verdict['max_logit_gap'] <= limit
               and verdict['steps'] >= int(mix['judge_min_steps']))
    for p in problems:
        print(f'not correct: {p}', file=sys.stderr)

    result = {'correct': bool(correct), 'attempted': attempted,
              'failed': failed, 'metrics': metrics,
              'device': device_info(cuda, peak)}
    if traced:
        result['device']['busy_s'] = summary.get('busy_s', 0.0)
        result['device']['window_s'] = summary.get('window_s', 0.0)
        result['breakdown'] = {'device_ops': summary.get('device_ops', []),
                               'idle_gaps': summary.get('idle_gaps', [])}
    # a checkout's first run builds the CUDA libraries: inside setup_s,
    # and recorded apart here
    result['build_s'] = build_s
    result['readings'] = verdict
    result['checks'] = checks
    return result


def device_info(cuda: bool, peak: int) -> dict:
    if not cuda:
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': 1, 'memory_peak_bytes': int(peak)}


def _finite(x):
    """x with every non-finite float as None (strict JSON)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def print_result(result: dict, out=None, err=None) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error; the result as the last line on standard output."""
    out = out or sys.stdout
    err = err or sys.stderr
    for name, c in result['checks'].items():
        rule = 'at_most' if 'at_most' in c else 'at_least'
        print(f'check {name} {c["value"]!r} {rule} {c[rule]!r}', file=err)
    err.flush()
    print(json.dumps(_finite(result), allow_nan=False), file=out)
    out.flush()
