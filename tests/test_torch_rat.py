"""The port's GDML/RATDB loader (chroma_tpu_torch/rat) against the JAX
package's, on the GDML and RATDB fixtures of tests/test_rat.py and on a
small SNO-like detector written by chip_smoke.sno_like_gdml.

Loading is host numpy in both packages: the volume trees, materials,
surfaces, meshes and channel maps must be equal (tolerance: none; every
array bit-equal, every material and surface equal field by field), and
the SNO-like detector's packed tables bit-equal as
tests/test_torch_tables.py compares them.  Its propagation draws
different random numbers in the two packages, so each outcome's share of
a 50,000-photon bomb must agree within 5 sigma of the Poisson errors.
"""
import json
import time

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax  # noqa: F401  (imported before torch, as the test files do)
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

import chip_smoke
from chroma_tpu import event as jevent
from chroma_tpu.generator.photon import photon_bomb as jphoton_bomb
from chroma_tpu.ops import geometry_pack as jgp
from chroma_tpu.rat import RATGeoLoader as JLoader
from chroma_tpu.rat import RatDBParser as JRatDBParser
from chroma_tpu.sim import Simulation as JSimulation
from chroma_tpu_torch import csg as pcsg
from chroma_tpu_torch import native as pnative
from chroma_tpu_torch.generator.photon import photon_bomb as pphoton_bomb
from chroma_tpu_torch.ops import geometry_pack as tgp
from chroma_tpu_torch.rat import RATGeoLoader as PLoader
from chroma_tpu_torch.rat import RatDBParser as PRatDBParser
from chroma_tpu_torch.rat import loader as ploader
from chroma_tpu_torch.sim import Simulation as PSimulation
from tests.test_rat import CONFORMAL_GDML, GDML, classifier
from tests.test_torch_csg import jax_native
from tests.test_torch_tables import _assert_equal_tables

NSNO = 24               # PMTs of the small SNO-like detector
NBOMB = 50000


def same_value(a, b, where):
    """Material/surface fields equal: arrays bit-equal with their
    dtypes, containers element by element, objects field by field."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == 'f'), where
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same_value(x, y, '%s[%d]' % (where, i))
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            same_value(a[k], b[k], '%s[%r]' % (where, k))
    elif hasattr(a, '__dict__'):
        assert type(a).__name__ == type(b).__name__, where
        same_value(vars(a), vars(b), where + '.' + type(a).__name__)
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def same_objects(xs, ys, where):
    """Two per-triangle object arrays (materials or surfaces, or None)
    name the same objects in the same places."""
    assert len(xs) == len(ys), where
    for obj in {id(x): x for x in xs}.values():
        at = np.array([x is obj for x in xs])
        partner = ys[np.argmax(at)]
        assert all(y is partner for y in ys[at]), where
        if obj is None:
            assert partner is None, where
        else:
            same_value(obj, partner, where)


def assert_volumes_equal(p, j):
    pv, jv = list(p.walk()), list(j.walk())
    assert len(pv) == len(jv)
    for a, b in zip(pv, jv):
        for f in ('name', 'placement', 'material_ref', 'parent_material_ref',
                  'solid_ref', 'pmt_type', 'pmt_channel'):
            assert getattr(a, f) == getattr(b, f), f
        for f in ('absolute_pos', 'absolute_rot'):
            same_value(getattr(a, f), getattr(b, f), f)


def assert_detectors_equal(p, j):
    """Solids (meshes, materials, surfaces, colors) and channel maps."""
    assert len(p.solids) == len(j.solids)
    for i, (ps, js) in enumerate(zip(p.solids, j.solids)):
        for f in ('vertices', 'triangles'):
            same_value(getattr(ps.mesh, f), getattr(js.mesh, f),
                       'solid %d %s' % (i, f))
        same_value(ps.color, js.color, 'solid %d color' % i)
        for f in ('inner_material', 'outer_material', 'surface'):
            same_objects(getattr(ps, f), getattr(js, f),
                         'solid %d %s' % (i, f))
        for f in ('unique_materials', 'unique_surfaces'):
            same_value(getattr(ps, f), getattr(js, f), 'solid %d %s' % (i, f))
    for f in ('solid_rotations', 'solid_displacements',
              'solid_id_to_channel_index', 'channel_index_to_solid_id',
              'channel_index_to_channel_type', 'channel_index_to_position'):
        same_value(getattr(p, f), getattr(j, f), f)
    same_value(p.detector_material, j.detector_material, 'detector_material')


def assert_flat_equal(p, j):
    """The flattened detectors' arrays."""
    p.flatten()
    j.flatten()
    for f in ('vertices', 'triangles'):
        same_value(getattr(p.mesh, f), getattr(j.mesh, f), 'mesh ' + f)
    for f in ('colors', 'solid_id', 'inner_material_index',
              'outer_material_index', 'surface_index',
              'unique_materials', 'unique_surfaces'):
        same_value(getattr(p, f), getattr(j, f), f)


@pytest.fixture(params=['gdml', 'conformal_gdml'])
def gdml_file(request, tmp_path):
    path = tmp_path / (request.param + '.gdml')
    path.write_text(GDML if request.param == 'gdml' else CONFORMAL_GDML)
    return str(path)


def omit_world(volume_ref, material_ref, parent_material_ref):
    if volume_ref == 'world_log':
        return 'omit', dict()
    return 'solid', dict()


@pytest.fixture(scope='module')
def natives():
    """Both packages' native libraries (CSG and BVH helpers) loaded."""
    assert pnative.native() is not None and jax_native() is not None


def test_hierarchy_and_optics_match_jax(gdml_file):
    p, j = PLoader(gdml_file), JLoader(gdml_file)
    assert_volumes_equal(p.world, j.world)
    assert sorted(p.placement_to_volume_map) \
        == sorted(j.placement_to_volume_map)
    assert p.material_lookup == j.material_lookup
    same_value(p.materials_used, j.materials_used, 'materials')
    same_value(p.surfaces_used, j.surfaces_used, 'surfaces')
    assert p.skin_surface_map.keys() == j.skin_surface_map.keys()
    assert [sorted(pair) for pair, _ in p.border_surfaces] \
        == [sorted(pair) for pair, _ in j.border_surfaces]


@pytest.mark.parametrize('conformal', [True, False])
def test_build_detector_matches_jax(gdml_file, conformal, natives):
    cls = classifier if 'conformal' not in gdml_file else omit_world
    p = PLoader(gdml_file).build_detector(volume_classifier=cls,
                                          conformal=conformal)
    j = JLoader(gdml_file).build_detector(volume_classifier=cls,
                                          conformal=conformal)
    assert_detectors_equal(p, j)
    assert_flat_equal(p, j)
    if 'conformal' in gdml_file:
        counts = sorted(len(s.mesh.triangles) for s in p.solids)
        assert counts == ([12, 16] if conformal else [16, 16])


def test_boolean_solids_match_jax(tmp_path, natives):
    """GDML subtraction and union solids through the native backend of
    both packages (the Python backend is held against the JAX package's
    in tests/test_torch_csg.py: on these 4,416-triangle orbs it takes
    minutes)."""
    path = tmp_path / 'det.gdml'
    path.write_text(GDML)
    p, j = PLoader(str(path)), JLoader(str(path))
    for solid in ('bore_s', 'holed_block_s', 'snowman_s'):
        pm, jm = p.build_mesh(solid), j.build_mesh(solid)
        assert len(pm.triangles) > 0
        for f in ('vertices', 'triangles'):
            same_value(getattr(pm, f), getattr(jm, f), solid + ' ' + f)
    # the loader's boolean is csg.boolean on placed meshes
    pm = p.build_mesh('holed_block_s')
    want = pcsg.boolean('subtraction', p.build_mesh('block_s'),
                        p.build_mesh('bore_s'))
    same_value(pm.triangles, want.triangles, 'holed block')


def test_ratdb_overrides_match_jax(tmp_path):
    """Default, run and user planes merge the same way in both."""
    entries = [
        {'name': 'GEO', 'index': 'pmts', 'valid_begin': 0, 'valid_end': 0,
         'type': 'pmtarray', 'pos_table': 'PMTINFO'},
        {'name': 'PMTINFO', 'index': '', 'valid_begin': 0, 'valid_end': 0,
         'x': [0.0], 'y': [0.0], 'z': [400.0], 'type': [1]},
        {'name': 'PMTINFO', 'index': '', 'valid_begin': -1,
         'valid_end': -1, 'type': [2]},
        {'name': 'PMTINFO', 'index': '', 'valid_begin': 100,
         'valid_end': 200, 'z': [410.0]},
        {'name': 'DAQ', 'index': 'trigger', 'valid_begin': 0,
         'valid_end': 0, 'threshold': 3},
    ]
    path = tmp_path / 'db.json'
    path.write_text(json.dumps(entries))
    for kw in (dict(), dict(run_number=150), dict(merge=False)):
        p, j = PRatDBParser(str(path), **kw), JRatDBParser(str(path), **kw)
        assert p.entries == j.entries and p.db == j.db
        for table, index in (('PMTINFO', ''), ('GEO', 'pmts'),
                             ('DAQ', 'trigger'), ('NONE', 'x')):
            assert p.get_entry(table, index) == j.get_entry(table, index)
        for as_list in (False, True):
            assert p.get_table('PMTINFO', as_list=as_list) \
                == j.get_table('PMTINFO', as_list=as_list)
    p = PRatDBParser(str(path))
    assert p.get_entry('PMTINFO', '')['type'] == [2]
    assert p.get_entry('PMTINFO', '')['z'] == [410.0]


# ---- the SNO-like detector ----------------------------------------------

@pytest.fixture(scope='module')
def sno_files(tmp_path_factory):
    path = tmp_path_factory.mktemp('sno') / 'sno.gdml'
    return chip_smoke.sno_like_gdml(NSNO, str(path))


def load_sno(loader_cls, files):
    gdml, ratdb = files
    loader = loader_cls(gdml, ratdb_file=ratdb)
    loader.add_pmt_info()
    det = loader.build_detector(volume_classifier=chip_smoke.sno_classifier)
    return loader, det


@pytest.fixture(scope='module')
def sno_detectors(sno_files, natives):
    (pl, pdet), (jl, jdet) = load_sno(PLoader, sno_files), \
        load_sno(JLoader, sno_files)
    return pl, pdet, jl, jdet


def test_sno_like_placements_face_the_center():
    """Every PMT's local +z (its face) points at the center under the
    loader's rotation, and the PMTs sit 8.89 m out, apart from each
    other by more than a concentrator's 270 mm, at the full count too."""
    for n in (NSNO, chip_smoke.SNO_NPMT):
        pos, angles = chip_smoke.sno_pmt_placements(n)
        assert np.allclose(np.linalg.norm(pos, axis=1),
                           chip_smoke.SNO_PSUP_RADIUS)
        if n == NSNO:
            for p, a in zip(pos, angles):
                rot = ploader._euler_xyz(a)
                assert np.allclose(rot @ [0.0, 0.0, 1.0],
                                   -p / np.linalg.norm(p), atol=1e-12)
    # nearest neighbours of the full Fibonacci sphere, on a sample
    pos, _ = chip_smoke.sno_pmt_placements(chip_smoke.SNO_NPMT)
    sample = pos[::37]
    d = np.linalg.norm(sample[:, None, :] - pos[None, :, :], axis=2)
    d[d == 0] = np.inf
    assert d.min() > 2 * (chip_smoke.SNO_CONC_RMIN[-1]
                          + chip_smoke.SNO_CONC_WALL) + 10.0


def test_sno_like_loader_matches_jax(sno_detectors):
    pl, pdet, jl, jdet = sno_detectors
    assert_volumes_equal(pl.world, jl.world)
    assert pl.nPMTs == jl.nPMTs == NSNO
    same_value(pl.pmt_index_to_position, jl.pmt_index_to_position,
               'pmt positions')
    assert pl.pmt_index_to_type == jl.pmt_index_to_type == [1] * NSNO
    assert_detectors_equal(pdet, jdet)
    assert pdet.num_channels() == NSNO
    # two volumes a PMT, the vessel and its heavy water; nothing
    # deduplicated
    assert len(pdet.solids) == 2 * NSNO + 2
    ntri = sorted(len(s.mesh.triangles) for s in pdet.solids)
    assert ntri == [1024] * NSNO + [1152] * NSNO + [4416] * 2
    names = {s.name for solid in pdet.solids
             for s in solid.unique_surfaces if s is not None}
    assert names == {'photocathode', 'concentrator'}


def test_sno_like_tables_match_jax(sno_detectors):
    """Flattened and packed by both packages: every table bit-equal, and
    the table is flat (each volume has its own mesh)."""
    _, pdet, _, jdet = sno_detectors
    assert_flat_equal(pdet, jdet)
    jgeom, jdt = jgp.pack_detector(jdet)
    pgeom, pdt = tgp.pack_detector(pdet, 'cpu')
    assert not pgeom.mbvh_instanced and pgeom.has_surfaces
    assert pdt.nchannels == NSNO
    _assert_equal_tables(jgeom, pgeom)
    _assert_equal_tables(jdt, pdt)


def outcome_counts(events):
    flags = np.concatenate([ev.photons_end.flags for ev in events])
    return {name: int(((flags & bit) != 0).sum()) for name, bit in (
        ('detect', jevent.SURFACE_DETECT), ('no_hit', jevent.NO_HIT),
        ('bulk_absorb', jevent.BULK_ABSORB),
        ('rayleigh', jevent.RAYLEIGH_SCATTER),
        ('reflect_specular', jevent.REFLECT_SPECULAR))}, len(flags)


def test_sno_like_bomb_matches_jax(sno_detectors):
    """A 50,000-photon isotropic 400 nm bomb at the center, propagated
    on the port's CPU path and by the JAX package: each outcome's share
    within 5 sigma, and >= 99% of photons terminal."""
    _, pdet, _, jdet = sno_detectors
    t0 = time.time()
    np.random.seed(61)
    pph = pphoton_bomb(NBOMB, 400.0, (0.0, 0.0, 0.0)).photons_beg
    np.random.seed(61)
    jph = jphoton_bomb(NBOMB, 400.0, (0.0, 0.0, 0.0)).photons_beg
    assert np.array_equal(pph.dir, jph.dir)
    pev = list(PSimulation(pdet, seed=5, device='cpu').simulate(
        [pph], keep_photons_end=True))
    jev = list(JSimulation(jdet, seed=5, geant4_processes=0).simulate(
        [jph], keep_photons_end=True))
    (pc, pn), (jc, jn) = outcome_counts(pev), outcome_counts(jev)
    assert pn == jn == NBOMB
    assert pc['detect'] > 0 and pc['no_hit'] > 0.5 * NBOMB, pc
    for name in pc:
        a, b = pc[name] / pn, jc[name] / jn
        sigma = np.sqrt(pc[name] + jc[name] + 1.0) / NBOMB
        assert abs(a - b) < 5.0 * sigma, (name, pc, jc)
    flags = pev[0].photons_end.flags
    assert ((flags & jevent.TERMINAL_FLAGS) != 0).mean() >= 0.99
    hit = pev[0].flat_hits
    assert len(hit) == pc['detect'] and (hit.channel < NSNO).all()
    assert time.time() - t0 < 600
