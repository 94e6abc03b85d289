"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""
import json
import os
import re

import pytest

from portbench import harness
from portbench.tests import tinytree

ROOT = tinytree.ROOT
with open(os.path.join(ROOT, 'BENCHMARK.json')) as _f:
    M = json.load(_f)

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
TEXT_KEYS = ('why', 'layer', 'source')


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s \
        and '\t' not in s


def test_top_level_keys():
    assert set(M) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) < 64 * 1024


def test_paths_and_command():
    assert 1 <= len(M['paths']) <= 16
    for p in M['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = M['command']
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert _text_ok(word) and not word.startswith('/') \
            and '..' not in word
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + '/') for p in M['paths'])


@pytest.mark.parametrize('entry', M['configs'] + M['workloads']
                         + M['end_to_end'] + M['per_layer'],
                         ids=lambda e: e['name'])
def test_names_units_and_texts(entry):
    assert NAME.match(entry['name'])
    for key in ('config', 'traffic'):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get('reduced', []):
        assert NAME.match(key)
    assert len(entry.get('reduced', [])) <= 16
    if 'unit' in entry:
        assert UNIT.match(entry['unit'])
        assert entry['better'] in ('lower', 'higher')
    for key in TEXT_KEYS:
        if key in entry:
            assert _text_ok(entry[key]), key


def test_names_unique():
    for group in (M['configs'], M['workloads'],
                  M['end_to_end'] + M['per_layer']):
        names = [e['name'] for e in group]
        assert len(names) == len(set(names))


def test_entries_have_only_their_keys():
    allowed = dict(
        configs={'name', 'source', 'file', 'reduced', 'why'},
        workloads={'name', 'config', 'traffic', 'chips', 'why'},
        end_to_end={'name', 'unit', 'better', 'bound', 'source',
                    'workloads'},
        per_layer={'name', 'unit', 'better', 'source', 'layer', 'moves',
                   'workloads'})
    for group, keys in allowed.items():
        for e in M[group]:
            assert set(e) <= keys, (group, e['name'])


def test_bounds_and_sources():
    names = {m['name'] for m in M['end_to_end']}
    assert 'setup_s' in names and 2 <= len(names) <= 16
    for m in M['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in M['per_layer']:
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert m['moves'] in names


def test_run_seconds_fit_a_full_check():
    rs = M['run_seconds']
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_four_chip_cells():
    four = [w for w in M['workloads'] if w['chips'] == 4]
    assert all(w['chips'] in (1, 4) for w in M['workloads'])
    assert len(four) <= max(1, len(M['workloads']) // 4)


def test_every_config_used_and_every_pair_once():
    used = {w['config'] for w in M['workloads']}
    assert used == {c['name'] for c in M['configs']}
    pairs = [(w['config'], w['traffic']) for w in M['workloads']]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize('cell', [w['name'] for w in M['workloads']])
def test_cell_finds_its_files(cell):
    c = harness.Cell(cell)
    assert c.config['name'] == c.workload['config']
    assert hasattr(c.config_module, 'load')
    assert hasattr(c.config_module, 'reference')
    assert hasattr(c.check_module, 'compare')
    assert hasattr(c.entry_module, 'Entry')
    assert c.traffic['rate'] in {m['name'] for m in M['end_to_end']}
    assert c.traffic['trace_seconds'] > 0
    assert os.path.exists(os.path.join(c.bench, 'sources',
                                       c.traffic['source']['kind'] + '.py'))
    assert set(c.limits['numbers']) >= {'hits_bad', 'yield_dev',
                                        'yield_crossed_dev', 'daq_bad'}
    for spec in c.limits['numbers'].values():
        assert spec['lower'] <= spec['limit'] < spec['upper']
    e2e = {m['name'] for m in c.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m['moves'] in e2e
        assert hasattr(c.metric_reader(m['name']), 'read')


def test_cell_added_with_new_files_only(tmp_path):
    manifest = tinytree.make_tree(str(tmp_path))
    bench = tmp_path / 'portbench'
    for dirpath, _, files in os.walk(tinytree.BENCH):
        if '.cache' in dirpath or '__pycache__' in dirpath \
                or os.sep + 'tests' in dirpath:
            continue
        for f in files:
            src = os.path.join(dirpath, f)
            rel = os.path.relpath(src, tinytree.BENCH)
            with open(src, 'rb') as a, open(bench / rel, 'rb') as b:
                assert a.read() == b.read(), rel
    assert harness.Cell(tinytree.SNO, manifest).traffic['source']['kind'] \
        == 'muon_chord'
    # the fit cell: a source kind, an entry, a check, a per-layer metric
    # and an end-to-end metric the benchmark does not have, from new
    # files and new manifest entries only
    c = harness.Cell(tinytree.FIT, manifest)
    assert c.traffic['source']['kind'] == 'point_bomb_tiny'
    assert c.traffic['entry'] == 'eval_pdf_tiny'
    assert c.limits['check'] == 'reference/check_pdf_tiny.py'
    assert [m['name'] for m in c.end_to_end] == ['setup_s',
                                                 'pdf_evals_per_s']
    assert [m['name'] for m in c.per_layer] == ['daq_acquires_tiny']
    assert hasattr(c.metric_reader('daq_acquires_tiny'), 'instrument')
    for name in ('sources/point_bomb_tiny.py', 'entries/eval_pdf_tiny.py'):
        assert not os.path.exists(os.path.join(tinytree.BENCH, name))
