"""A benchmark tree with test-sized cells added as new files only, for
tests on the CPU: the SNO-like detector at 2,000 PMTs under the muon
mix cut to 400-420 nm, and under a likelihood fit's PDF evaluation,
which brings a source kind, an entry, a check, a metric and an
end-to-end metric that the benchmark does not have."""
import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
DATA = os.path.join(BENCH, 'tests', 'data')
SNO = 'sno_tiny-muon_tiny'
FIT = 'sno_tiny-fit_tiny'
# (file under tests/data, where it goes in the tree)
NEW_FILES = (
    ('sno_tiny.json', 'configs/sno_tiny.json'),
    ('muon_tiny.json', 'traffic/muon_tiny.json'),
    ('limits_sno_tiny.json', 'limits/%s.json' % SNO),
    ('fit_tiny.json', 'traffic/fit_tiny.json'),
    ('limits_fit_tiny.json', 'limits/%s.json' % FIT),
    ('plugins/sources/point_bomb_tiny.py', 'sources/point_bomb_tiny.py'),
    ('plugins/entries/eval_pdf_tiny.py', 'entries/eval_pdf_tiny.py'),
    ('plugins/reference/check_pdf_tiny.py',
     'reference/check_pdf_tiny.py'),
    ('plugins/metrics/daq_acquires_tiny.py',
     'metrics/daq_acquires_tiny.py'),
)


def make_tree(dest):
    """Copy the benchmark into ``dest`` and add the test cells; returns
    the manifest's path."""
    bench = os.path.join(dest, 'portbench')
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        '.cache', '__pycache__', 'tests'))
    for src, dst in NEW_FILES:
        assert not os.path.exists(os.path.join(bench, dst)), dst
        shutil.copy(os.path.join(DATA, src), os.path.join(bench, dst))
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        manifest = json.load(f)
    manifest['configs'].append(dict(
        name='sno_tiny', source='a test size of the benchmark detector',
        file='portbench/configs/sno_tiny.json', reduced=[],
        why='a test size'))
    manifest['workloads'] += [
        dict(name=SNO, config='sno_tiny', traffic='muon_tiny', chips=1,
             why='the muon mix at a test size'),
        dict(name=FIT, config='sno_tiny', traffic='fit_tiny', chips=1,
             why="a fit's PDF evaluation at a test size")]
    for m in manifest['end_to_end'] + manifest['per_layer']:
        if 'workloads' in m and 'sno_like-muon16m.steps' in m['workloads']:
            m['workloads'].append(SNO)
    manifest['end_to_end'].append(dict(
        name='pdf_evals_per_s', unit='evals/s', better='higher',
        bound=0.25, source='host_clock', workloads=[FIT]))
    manifest['per_layer'].append(dict(
        name='daq_acquires_tiny', unit='calls', better='lower',
        source='program_counter', layer='ops/daq.GPUDaq',
        moves='pdf_evals_per_s', workloads=[FIT]))
    path = os.path.join(dest, 'BENCHMARK.json')
    with open(path, 'w') as f:
        json.dump(manifest, f, indent=1)
    return path
