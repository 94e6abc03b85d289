"""A whole run on the CPU at a test size: the result line against the
contract, the traced run's per-layer metrics, the check seeing each
planted fault and the lower-precision control, a cell made of new files
only (a new source kind, entry, check, metric and end-to-end metric),
and the reference's channel map against the program's detector."""
import io
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests import tinytree

SEED = 2 ** 31 + 77


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp('bench')
    cache = tmp_path_factory.mktemp('cache')
    old = os.environ.get('CHROMA_TPU_CACHE')
    os.environ['CHROMA_TPU_CACHE'] = str(cache)
    saved = harness.CACHE_DIR
    harness.CACHE_DIR = str(cache)
    yield tinytree.make_tree(str(d))
    harness.CACHE_DIR = saved
    if old is None:
        del os.environ['CHROMA_TPU_CACHE']
    else:
        os.environ['CHROMA_TPU_CACHE'] = old


def _run(tree, cell, mode=None, trace=False, seconds=2.0):
    c = harness.Cell(cell, tree)
    return harness.run(c, SEED, seconds, trace=trace, device='cpu',
                       mode=mode)


@pytest.fixture(scope='module')
def sound(tree):
    return _run(tree, tinytree.SNO)


def test_result_line(sound):
    out, err = io.StringIO(), io.StringIO()
    assert harness.report(dict(sound), out, err) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:3] == ['correct', 'attempted', 'failed']
    assert list(line)[-1] == 'checks'
    assert set(line) >= {'correct', 'attempted', 'failed', 'metrics',
                         'device'}
    assert line['correct'] is True and line['failed'] == 0
    assert line['attempted'] >= 1
    assert set(line['metrics']) == {'photons_per_s', 'setup_s'}
    assert line['metrics']['photons_per_s']['unit'] == 'photons/s'
    assert line['metrics']['setup_s']['value'] > 0
    for name, c in line['checks'].items():
        assert c['value'] <= c['limit'], name
    tail = err.getvalue().strip().splitlines()[-len(line['checks']):]
    assert all(t.startswith('portbench: ') and ' limit ' in t for t in tail)
    assert set(line['checks']) == {'hits_bad', 'yield_dev',
                                   'yield_crossed_dev', 'daq_bad'}


def test_traced_run(tree, monkeypatch):
    # the first call traced, the rest of the window not: a clock that
    # moves one second a reading makes the split the same on any host
    ticks = itertools.count()
    monkeypatch.setattr(harness, 'clock', lambda: float(next(ticks)))
    r = _run(tree, tinytree.SNO, trace=True, seconds=8.0)
    assert r['correct'] is True
    m = r['metrics']
    assert {'steps_per_batch', 'ms_per_step'} <= set(m)
    assert 'photons_per_s' not in m
    assert r['device']['window_s'] > 0
    assert len(r['breakdown']['device_ops']) <= 10
    assert len(r['breakdown']['idle_gaps']) <= 10


@pytest.mark.parametrize('mode', ['control', 'unchanged', 'half',
                                  'altered'])
def test_check_sees_fault(tree, sound, mode):
    r = _run(tree, tinytree.SNO, mode=mode)
    assert r['correct'] is False
    failed = [k for k, c in r['checks'].items() if c['value'] > c['limit']]
    assert failed, r['checks']


@pytest.mark.parametrize('mode', ['d2o_abs'])
def test_check_sees_a_wrong_absorption_length(tree, sound, mode):
    """A medium inside the vessel absorbing ten times too strongly takes
    crossed photons away, and no others."""
    r = _run(tree, tinytree.SNO, mode=mode)
    got, ref = r['_counts'], sound['_counts']
    assert got['crossed_expected'] == pytest.approx(ref['crossed_expected'])
    assert got['crossed_observed'] < 0.8 * ref['crossed_observed']
    assert r['checks']['yield_crossed_dev']['value'] \
        > sound['checks']['yield_crossed_dev']['value']


def test_a_cell_of_new_files_runs(tree):
    r = _run(tree, tinytree.FIT, seconds=1.0)
    assert r['correct'] is True, r['checks']
    assert set(r['metrics']) == {'pdf_evals_per_s', 'setup_s'}
    assert r['metrics']['pdf_evals_per_s']['unit'] == 'evals/s'
    assert r['metrics']['pdf_evals_per_s']['value'] > 0
    assert set(r['checks']) == {'pdf_bad'}
    t = _run(tree, tinytree.FIT, trace=True, seconds=1.0)
    assert t['metrics']['daq_acquires_tiny']['value'] > 0
    assert 'pdf_evals_per_s' not in t['metrics']


def test_sno_channels_follow_the_loader(tmp_path):
    from chroma_tpu_torch.detector import Detector
    from chroma_tpu_torch.rat import RATGeoLoader
    from portbench.configs import sno_like, sno_like_gdml
    cfg = dict(npmt=30, channels=30, search_radius_mm=8860.0,
               av_radius_mm=6000.0, av_wall_mm=55.0, time_dist={},
               charge_dist={})
    path, ratdb = sno_like_gdml.sno_like_gdml(30, str(tmp_path / 's.gdml'))
    loader = RATGeoLoader(path, ratdb_file=ratdb)
    loader.add_pmt_info()
    d2o = loader.materials_used[loader.material_lookup['heavy_water']]
    det = loader.build_detector(detector=Detector(d2o),
                                volume_classifier=sno_like._sno_classifier)
    det.flatten()
    ref = sno_like.reference(cfg, torch.device('cpu')).centers.numpy()
    solid = det.solid_id_to_channel_index[det.solid_id]
    verts = det.mesh.vertices[det.mesh.triangles]
    for k in range(30):
        mean = verts[solid == k].reshape(-1, 3).mean(0)
        assert np.argmin(np.linalg.norm(ref - mean, axis=1)) == k


def test_run_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, 'portbench/run.py', '--workload',
                        'sno_like-muon16m.steps', '--seed', '1',
                        '--seconds', '1', '--trace', '0'],
                       cwd=tinytree.ROOT, capture_output=True, text=True,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert p.returncode != 0
    assert not any(ln.startswith('{') for ln in p.stdout.splitlines())


def test_run_without_the_program_fails(tmp_path):
    import shutil
    shutil.copy(os.path.join(tinytree.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(tinytree.BENCH, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    p = subprocess.run([sys.executable, 'portbench/run.py', '--workload',
                        'sno_like-muon16m.steps', '--seed', '1',
                        '--seconds', '1', '--trace', '0'],
                       cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0
    assert not any(ln.startswith('{') for ln in p.stdout.splitlines())


@pytest.mark.cuda
def test_on_the_card_sound_passes_and_control_fails(tree):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the walker kernels have no '
                    'CPU build')
    c = harness.Cell(tinytree.SNO, tree)
    assert harness.run(c, SEED, 2.0)['correct'] is True
    assert harness.run(c, SEED, 2.0, mode='control')['correct'] is False
