"""The port's driver modes against the JAX package's.

The integer operations are bit-equal to the JAX functions:
``fused._compact_order`` (the permutation of ``_compact_lanes``),
``photon._morton_key``, ``sort_photons`` and ``partition_photons``.

The step loop with Morton sorting (``sort_every``) and the compacting
driver (``propagate_compacting``) give, once put back in order, the
step loop's photons bit for bit: a photon reads the draw row of its own
index whatever its place in the batch.

Each new mode of the lane-pool driver (``ondeck=False``, ``prune='off'``,
``service_frac``, ``chains=3`` with n % 3 != 0, drain compaction) and the
compacting driver is held against the same mode of the JAX package
(the jnp walker; ``MIN_CHAIN_WIDTH`` patched as
tests/test_propagation.py patches it) on a mirror box: a 200 mm cube
whose walls reflect (0.6 specular, 0.2 diffuse), absorb 0.15 and detect
0.05, filled with a medium that scatters (300 mm) and absorbs (2 m),
~5.7 steps a photon.  The draws differ (a torch.Generator against
threefry), so as tests/test_propagation.py:273, 396 and 441 do: every
photon terminal, order kept (``evidx`` carries the input order), each
flag's rate within 6 binomial sigma of the two runs plus 0.005, the mean
arrival time within 0.1 of its spread.

Drain compaction (``DRAIN_MIN_WIDTH`` and ``DRAIN_MIN_LANES`` patched so
that it engages at 512 lanes) on nested vacuum spheres, where every
photon's path is fixed (no scattering, absorption or reflection between
equal indices), gives the same photons bit for bit and the same stats
(passes, photon-steps, lane-iterations) as the driver without it.
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu import event as jevent, geometry as jgeometry, make as jmake
from chroma_tpu.ops import fused as F
from chroma_tpu.ops import geometry_pack as jgp
from chroma_tpu.ops import photon as jphoton
from chroma_tpu_torch import event, geometry, make
from chroma_tpu_torch.ops import fused, photon
from chroma_tpu_torch.ops.geometry_pack import pack_geometry
from tests.test_torch_fused import _port_state
from tests.test_torch_tables import port_tables

N = 3000
MAX_STEPS = 100
FLAGS = ('SURFACE_DETECT', 'SURFACE_ABSORB', 'BULK_ABSORB',
         'RAYLEIGH_SCATTER', 'REFLECT_SPECULAR', 'REFLECT_DIFFUSE', 'NO_HIT')


def mirror_box(G, mk):
    medium = G.Material('murk')
    medium.set('refractive_index', 1.33)
    medium.set('absorption_length', 2000.0)
    medium.set('scattering_length', 300.0)
    wall = G.Surface('wall')
    wall.set('reflect_specular', 0.6)
    wall.set('reflect_diffuse', 0.2)
    wall.set('absorb', 0.15)
    wall.set('detect', 0.05)
    geo = G.Geometry(medium)
    geo.add_solid(G.Solid(mk.box(200.0, 200.0, 200.0), medium, medium,
                          surface=wall))
    geo.flatten()
    return geo


@pytest.fixture(scope='module')
def box():
    jgeom = jgp.pack_geometry(mirror_box(jgeometry, jmake))
    return jgeom, port_tables(jgeom)[0]


def jax_photons(n, seed):
    """n photons inside the box, isotropic, 400 nm, evidx = input order."""
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1)[:, None]
    pol = np.cross(rng.normal(size=(n, 3)), d).astype(np.float32)
    pol /= np.linalg.norm(pol, axis=1)[:, None]
    p = jevent.Photons(pos=rng.uniform(-90, 90, (n, 3)).astype(np.float32),
                       dir=d, pol=pol,
                       wavelengths=np.full(n, 400.0, np.float32))
    p.evidx = np.arange(n, dtype=np.uint32)
    return jphoton.upload_photons(p)


def port_fused(pgeom, n, seed=19, **kw):
    state = _port_state(jax_photons(n, 5))
    gen = torch.Generator()
    gen.manual_seed(seed)
    out, stats = fused.propagate_fused(state, pgeom, fused.uniform_draws(gen),
                                       max_steps=MAX_STEPS, **kw)
    assert torch.equal(out['index'], state['index'])
    return out, stats


def jax_fused(jgeom, n, monkeypatch=None, **kw):
    out, stats = F.propagate_fused(jax_photons(n, 5), jgeom,
                                   jax.random.PRNGKey(3), max_steps=MAX_STEPS,
                                   use_pallas=False, **kw)
    return {k: np.asarray(v) for k, v in out.items()}, np.asarray(stats)


def assert_same_physics(ref, out):
    """ref: JAX photons (numpy); out: the port's (torch)."""
    n = len(ref['flags'])
    flags = out['flags'].numpy().view(np.uint32)
    # order kept, every photon terminal
    assert np.array_equal(out['evidx'].numpy().view(np.uint32),
                          np.arange(n, dtype=np.uint32))
    assert ((flags & jevent.TERMINAL_FLAGS) != 0).all()
    assert ((ref['flags'] & jevent.TERMINAL_FLAGS) != 0).all()
    for name in FLAGS:
        bit = getattr(event, name)
        rj = ((ref['flags'] & bit) != 0).mean()
        rp = ((flags & bit) != 0).mean()
        sigma = np.sqrt(max(rj * (1 - rj), 1e-4) * 2 / n)
        assert abs(rj - rp) < 6 * sigma + 0.005, (name, rj, rp)
    t = out['t'].numpy()
    assert abs(t.mean() - ref['t'].mean()) < 0.1 * ref['t'].std() + 1e-3


# ---- integer operations, bit-equal ----------------------------------------

@pytest.mark.parametrize('n,m', [(1, 1), (200, 25), (4096, 512), (777, 700)])
def test_compact_order_matches_jax(n, m):
    rng = np.random.RandomState(n)
    holding = rng.rand(n) < 0.3
    lane = {'holding': jnp.asarray(holding),
            'lane': jnp.arange(n, dtype=jnp.int32),
            'W_uregs': jnp.tile(jnp.arange(n, dtype=jnp.uint32), (2, 1)),
            'iters': jnp.zeros((), jnp.int32)}
    ref = F._compact_lanes(lane, m)
    got = fused._compact_order(torch.from_numpy(holding), m).numpy()
    assert np.array_equal(got, np.asarray(ref['lane']))
    assert np.array_equal(got, np.asarray(ref['W_uregs'][1]))
    assert holding[got[:min(m, holding.sum())]].all()


def _random_state(n, seed):
    rng = np.random.RandomState(seed)
    st = jax_photons(n, seed)
    pos = rng.uniform(-150, 150, (n, 3)).astype(np.float32)  # some outside
    flags = np.where(rng.rand(n) < 0.3, jevent.BULK_ABSORB, 0) \
        .astype(np.uint32)
    return dict(st, pos=jnp.asarray(pos), flags=jnp.asarray(flags))


def test_morton_sort_partition_match_jax(box):
    jgeom, pgeom = box
    jstate = _random_state(5000, 2)
    pstate = _port_state(jstate)
    origin, inv = photon._world_box(pgeom)
    jinv = 1.0 / (jgeom.world_scale * 65535.0)
    assert np.array_equal(inv.numpy(), np.asarray(jinv))
    ref = np.asarray(jphoton._morton_key(jstate, jgeom.world_origin, jinv))
    key = photon._morton_key(pstate, origin, inv)
    assert key.dtype == torch.int64
    assert np.array_equal(key.numpy(), ref.astype(np.int64))
    assert (key.numpy()[np.asarray(jstate['flags']) != 0] == 0xFFFFFFFF).all()
    for jfn, tfn in ((lambda s: jphoton.sort_photons(s, jgeom.world_origin,
                                                     jinv),
                      lambda s: photon.sort_photons(s, origin, inv)),
                     (jphoton.partition_photons, photon.partition_photons)):
        jout, jorder = jfn(jstate)
        pout, porder = tfn(pstate)
        assert np.array_equal(porder.numpy(), np.asarray(jorder))
        for k in jout:
            a = np.asarray(jout[k])
            b = pout[k].numpy()
            if a.dtype == np.uint32:    # int32 bits or an int64 index
                a, b = a.astype(np.int64), b.astype(np.int64) & 0xFFFFFFFF
            assert b.dtype == a.dtype and np.array_equal(b, a), k


def test_next_pow2_matches_jax():
    for n in (0, 1, 2, 3, 255, 256, 257, 3000, 1 << 20):
        assert photon._next_pow2(n) == jphoton._next_pow2(n)


# ---- the step loop, sorted and compacting: bit-equal ----------------------

def _steps(pgeom, n, **kw):
    state = _port_state(jax_photons(n, 5))
    state['index'] = torch.arange(n)
    gen = torch.Generator()
    gen.manual_seed(7)
    draws = photon.uniform_draws(gen, n)
    return state, draws


def test_sorted_and_compacting_equal_step_loop(box):
    _, pgeom = box
    n = 2000
    state, draws = _steps(pgeom, n)
    ref, ref_steps = photon.propagate(state, pgeom, draws,
                                      max_steps=MAX_STEPS)
    assert ((ref['flags'] & photon.TERMINAL) != 0).all()
    for name, run in (
            ('sort_every=1', lambda s, d: photon.propagate(
                s, pgeom, d, max_steps=MAX_STEPS, sort_every=1)),
            ('sort_every=3', lambda s, d: photon.propagate(
                s, pgeom, d, max_steps=MAX_STEPS, sort_every=3)),
            ('compacting', lambda s, d: photon.propagate_compacting(
                s, pgeom, d, max_steps=MAX_STEPS, steps_per_round=2,
                min_bucket=512, trickle_rounds=8))):
        state, draws = _steps(pgeom, n)
        out, steps = run(state, draws)
        if name != 'compacting':
            assert not torch.equal(out['index'], ref['index']), name
            out = photon.unsort_photons(out)
        for k in ref:
            assert torch.equal(out[k].view(torch.int32)
                               if out[k].is_floating_point() else out[k],
                               ref[k].view(torch.int32)
                               if ref[k].is_floating_point() else ref[k]), \
                (name, k)


def test_gpuphotons_drivers_restore_order(box):
    """``GPUPhotons.propagate`` with 'steps' + ``sort_every`` and with
    'compacting' gives the photons back in upload order, with the
    caller's index, equal to the plain step loop's."""
    from chroma_tpu_torch import gpu
    _, pgeom = box
    jp = jax_photons(500, 5)
    ph = event.Photons(pos=np.asarray(jp['pos']), dir=np.asarray(jp['dir']),
                       pol=np.asarray(jp['pol']),
                       wavelengths=np.asarray(jp['wavelength']))
    holder = type('G', (), {'geom': pgeom})()
    outs = []
    for kw in (dict(driver='steps'), dict(driver='steps', sort_every=2),
               dict(driver='compacting')):
        gp = gpu.GPUPhotons(ph, 'cpu')
        gp.propagate(holder, gpu.get_rng_states(seed=4, device='cpu'),
                     max_steps=MAX_STEPS, **kw)
        assert torch.equal(gp.state['index'], torch.arange(500))
        assert gp.last_steps > 1
        outs.append(gp.get())
    for o in outs[1:]:
        for f in ('pos', 'dir', 'pol', 't', 'flags', 'last_hit_triangles'):
            assert np.array_equal(getattr(o, f), getattr(outs[0], f)), f


# ---- the driver modes against the JAX package's ----------------------------

@pytest.fixture(scope='module')
def jax_refs(box):
    jgeom, _ = box
    mp = pytest.MonkeyPatch()
    mp.setattr(F, 'MIN_CHAIN_WIDTH', 128)
    refs = dict(
        static=jax_fused(jgeom, N, width=512, prune='off'),
        frac=jax_fused(jgeom, N, width=512, service_frac=0.25),
        chains=jax_fused(jgeom, N + 1, width=768, chains=3),
        drain=jax_fused(jgeom, 4500, width=4224, chains=1))
    mp.undo()
    out, _ = jphoton.propagate_compacting(
        jax_photons(N, 5), jgeom, jax.random.PRNGKey(3), max_steps=MAX_STEPS,
        steps_per_round=2, min_bucket=512)
    refs['compacting'] = ({k: np.asarray(v) for k, v in out.items()}, None)
    return refs


MODES = [
    ('ondeck-off', 'static', N, dict(width=512, ondeck=False)),
    ('prune-off', 'static', N, dict(width=512, prune='off')),
    ('ondeck-off-prune-off', 'static', N,
     dict(width=512, ondeck=False, prune='off')),
    ('service-frac', 'frac', N, dict(width=512, service_frac=0.25)),
    ('chains-3', 'chains', N + 1, dict(width=768, chains=3)),
    ('drain', 'drain', 4500, dict(width=4224)),
]


@pytest.mark.parametrize('mode,ref,n,kw', MODES, ids=[m[0] for m in MODES])
def test_driver_mode_matches_jax(box, jax_refs, monkeypatch, mode, ref, n,
                                 kw):
    _, pgeom = box
    monkeypatch.setattr(fused, 'MIN_CHAIN_WIDTH', 128)
    out, stats = port_fused(pgeom, n, collect_stats=True, **kw)
    assert_same_physics(jax_refs[ref][0], out)
    jstats = jax_refs[ref][1]
    # the same photon-steps within 10%; the active lane-iterations at
    # most the lane-iterations (the box is one cluster row, so a walk is
    # active after an iteration only where an on-deck ray restarted it)
    assert abs(int(stats[1]) - int(jstats[1])) < 0.1 * int(jstats[1])
    assert 0 <= int(stats[3]) <= int(stats[2])


def test_compacting_matches_jax(box, jax_refs):
    _, pgeom = box
    state = _port_state(jax_photons(N, 5))
    state['index'] = torch.arange(N)
    gen = torch.Generator()
    gen.manual_seed(19)
    out, steps = photon.propagate_compacting(
        state, pgeom, photon.uniform_draws(gen, N), max_steps=MAX_STEPS,
        steps_per_round=2, min_bucket=512)
    assert torch.equal(out['index'], torch.arange(N))
    assert_same_physics(jax_refs['compacting'][0], out)


def test_chains_segments_and_service_frac_cadence(box, monkeypatch):
    """Three chains over 3001 photons own pool segments of 1001, 1000 and
    1000 photons and 256 lanes each; the dynamic cadence walks one
    iteration a launch and services once a quarter of the lanes have
    drained, so its lanes hold photons for fewer iterations than the
    static cadence's, in at least as many passes."""
    monkeypatch.setattr(fused, 'MIN_CHAIN_WIDTH', 128)
    assert fused._segments(3001, 768, 3) == ([0, 1001, 2001, 3001],
                                             [256, 256, 256])
    # fewer than MIN_CHAIN_WIDTH photons a chain: fewer chains
    assert fused._segments(300, 768, 3) == ([0, 150, 300], [150, 150])
    _, pgeom = box
    _, st_static = port_fused(pgeom, N, width=512, ondeck=False)
    _, st_frac = port_fused(pgeom, N, width=512, service_frac=0.25)
    assert int(st_frac[0]) >= int(st_static[0])
    assert int(st_frac[2]) < int(st_static[2])


def test_collect_stats_and_bad_prune(box):
    """stats[3] counts the lanes whose walk is active after an
    iteration: 0 unless asked for; on the nested spheres (an MBVH of
    more than one level) some, fewer than the lane-iterations, and the
    more without pruning."""
    _, pgeom = box
    _, stats = port_fused(pgeom, 600, width=256)
    assert int(stats[3]) == 0
    tables = nested_spheres()
    assert tables.mbvh_depth >= 2
    counts = {}
    for kw in (dict(), dict(prune='off'), dict(ondeck=False)):
        _, stats = port_fused(tables, 600, width=256, collect_stats=True,
                              **kw)
        counts[str(kw)] = int(stats[3])
        assert 0 < int(stats[3]) < int(stats[2]), (kw, stats)
    with pytest.raises(ValueError, match='prune'):
        port_fused(pgeom, 10, prune='sometimes')


# ---- drain compaction on fixed paths: the same photons ---------------------

def nested_spheres():
    geo = geometry.Geometry(geometry.vacuum)
    for r in (60.0, 120.0, 180.0):
        geo.add_solid(geometry.Solid(make.sphere(r, nsteps=16),
                                     geometry.vacuum, geometry.vacuum))
    geo.flatten()
    return pack_geometry(geo, 'cpu')


def test_drain_compaction_keeps_photons_and_steps(monkeypatch):
    tables = nested_spheres()
    monkeypatch.setattr(fused, 'DRAIN_MIN_WIDTH', 256)
    monkeypatch.setattr(fused, 'DRAIN_MIN_LANES', 16)
    real = fused._compact_lanes
    calls = []

    def counting(lane, chains, targets):
        calls.append((int(lane['holding'].sum()), list(targets)))
        return real(lane, chains, targets)

    monkeypatch.setattr(fused, '_compact_lanes', counting)
    runs = {}
    for shrink in ((8, 64), ()):
        calls.clear()
        state = _port_state(jax_photons(3000, 8))
        state['pos'] = state['pos'] * 1.5
        gen = torch.Generator()
        gen.manual_seed(3)
        out, stats = fused.propagate_fused(
            state, tables, fused.uniform_draws(gen), max_steps=MAX_STEPS,
            width=512, drain_shrink=shrink)
        runs[shrink] = (out, stats, list(calls))
    (a, sa, ca), (b, sb, cb) = runs[(8, 64)], runs[()]
    assert [t for _, t in ca] == [[64], [16]] and cb == []
    assert all(h <= t[0] for h, t in ca)
    # the same passes, photon-steps and (holding) lane-iterations: the
    # pool is dry when the lanes compact, so only the width shrinks
    assert torch.equal(sa, sb), (sa, sb)
    assert ((a['flags'] & event.NO_HIT) != 0).all()
    for k in a:
        x, y = a[k], b[k]
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), k
