"""Run cells several times, each run a process of its own as a check
makes them, and keep every result line.

    python3 portbench/series.py --out out/runs.jsonl \
        --seconds 51 --run sno_like-muon16m.steps:1,2,3 \
        --run sno_like-muon16m.steps:4,5:trace

Each ``--run`` is ``<cell>:<seed>,<seed>...`` with ``:trace`` for
``--trace 1``.  A line of the output file holds the cell, seed, exit
code, the wall seconds of the process and its result (or the end of its
standard error); a short summary of each run goes to standard output.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card():
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit,clocks.max.sm',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return 'nvidia-smi failed: %s' % e


def one(cell, seed, seconds, trace, timeout):
    cmd = [sys.executable, os.path.join('portbench', 'run.py'),
           '--workload', cell, '--seed', str(seed), '--seconds',
           str(seconds), '--trace', '1' if trace else '0']
    t0 = time.time()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or '', e.stderr or ''
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    wall = time.time() - t0
    lines = [ln for ln in out.strip().splitlines() if ln.startswith('{')]
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return dict(cell=cell, seed=seed, trace=trace, rc=rc, wall_s=wall,
                result=result, stderr_tail=err[-3000:])


def summary(rec):
    r = rec['result']
    if r is None:
        return '%s seed %s: rc %d, %.1f s; %s' % (
            rec['cell'], rec['seed'], rec['rc'], rec['wall_s'],
            rec['stderr_tail'][-800:])
    m = {k: v['value'] for k, v in r['metrics'].items()}
    c = {k: v['value'] for k, v in r['checks'].items()}
    return '%s seed %s trace %d: rc 0, %.1f s, correct %s, %d calls; %s; ' \
        'checks %s; peak %.2f GB' % (
            rec['cell'], rec['seed'], rec['trace'], rec['wall_s'],
            r['correct'], r['attempted'], json.dumps(m), json.dumps(c),
            r['device']['memory_peak_bytes'] / 1e9)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--out', required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--run', action='append', required=True)
    p.add_argument('--timeout', type=float, default=1200)
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    print('card: %s' % card(), flush=True)
    for spec in args.run:
        parts = spec.split(':')
        cell, seeds = parts[0], [int(s) for s in parts[1].split(',')]
        trace = len(parts) > 2 and parts[2] == 'trace'
        for seed in seeds:
            rec = one(cell, seed, args.seconds, trace, args.timeout)
            rec['card'] = card()
            with open(args.out, 'a') as f:
                f.write(json.dumps(rec) + '\n')
            print(summary(rec), flush=True)


if __name__ == '__main__':
    main()
