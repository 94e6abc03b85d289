"""Readings for the check's limits: sound runs, the lower-precision
control and the planted faults, at a cell's own size, in one process.

    python3 portbench/control.py --workload sno_like-muon16m.steps \
        --seconds 10 --seeds 11,12,13 --modes sound,control,half \
        --out out/control.jsonl

Modes: ``sound`` (the program as it is), ``control`` (the timed path's
outputs in the entry's lower precision: for ``simulate``, a photon state
kept in bfloat16, the precision below the configuration's float32), the
program faults of ``spans.fault`` (``unchanged``, ``half``, ``altered``)
and the table faults of the configuration's ``FAULTS`` (for
``sno_like``: ``d2o_abs``, ``acrylic_abs``).  The benchmark's own runs
never run these.  Each line of ``--out`` holds the mode, seed and the
compared numbers with their counts.
"""
import argparse
import json
import os
import sys
import time

T_PROCESS = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
os.environ['CHROMA_TPU_CACHE'] = os.path.join(ROOT, 'portbench', '.cache',
                                              'chroma_tpu')

from portbench import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--modes', default='sound,control')
    p.add_argument('--out', required=True)
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for mode in args.modes.split(','):
        for seed in [int(s) for s in args.seeds.split(',')]:
            t0 = time.time()
            r = harness.run(cell, seed, args.seconds,
                            mode=None if mode == 'sound' else mode)
            rec = dict(cell=args.workload, mode=mode, seed=seed,
                       correct=r['correct'], wall_s=time.time() - t0,
                       checks={k: v['value'] for k, v in
                               r['checks'].items()},
                       counts=r['_counts'], metrics={
                           k: v['value'] for k, v in r['metrics'].items()})
            with open(args.out, 'a') as f:
                f.write(json.dumps(rec) + '\n')
            print(json.dumps(rec), flush=True)


if __name__ == '__main__':
    main()
