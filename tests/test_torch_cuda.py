"""Hand-written CUDA kernels of chroma_tpu_torch against their plain
PyTorch versions, on the card; the gated physics models, one ``eval_pdf``
and tracking mode through those kernels; the step physics kernel against
``physics_update_plain`` and whole propagations through it.

These tests need an NVIDIA card and nvcc, and skip elsewhere.  They
import neither jax nor tests/conftest.py (which does), so on a card host
without JAX they run as

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Kernel and plain version must agree bit for bit: the kernel is built
with --fmad=false, so both round every product.
"""
import numpy as np
import pytest
import torch

from chroma_tpu_torch import host
from chroma_tpu_torch.ops import mbvh as tmbvh
from chroma_tpu_torch.ops import mbvh_walk
from chroma_tpu_torch.ops.geometry_pack import pack_geometry

# beside this file, found through the test's own folder on sys.path: a
# card host may install another package named ``tests``
import torch_scenes


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: CUDA kernels have no CPU build')
    return torch.device('cuda')


def _rays(n, seed, dev):
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.zeros((n, 3), device=dev), torch.from_numpy(d).to(dev))


def _assert_bit_equal(tables, o, d, lht=None, active=None):
    n = o.shape[0]
    lht = torch.full((n,), -1, dtype=torch.int32, device=o.device) \
        if lht is None else lht
    active = torch.ones(n, dtype=torch.bool, device=o.device) \
        if active is None else active
    args = (tables.mbvh_rows, o, d, lht, active, tmbvh.tquant_scale(tables),
            tables.mbvh_depth, tables.mbvh_instanced, 65536)
    before = mbvh_walk.closest_hit_launches.launches
    k = mbvh_walk.closest_hit_cuda(*args)
    torch.cuda.synchronize()
    assert mbvh_walk.closest_hit_launches.launches == before + 1
    p = mbvh_walk.closest_hit_plain(*args)
    for key in ('triangle', 'material_code', 'incomplete'):
        assert torch.equal(k[key], p[key]), key
    for key in ('distance', 'normal'):
        assert torch.equal(k[key].view(torch.int32),
                           p[key].view(torch.int32)), key
    return k


@pytest.mark.cuda
@pytest.mark.parametrize('n', [256, 341, 85, 129])
def test_walk_kernel_flat_sphere(dev, n):
    g = pack_geometry(host.mesh_geometry(host.make.sphere(50.0, nsteps=24)),
                      dev)
    k = _assert_bit_equal(g, *_rays(n, n, dev))
    assert (k['triangle'] >= 0).all()


@pytest.mark.cuda
def test_walk_kernel_lht_and_active(dev):
    g = pack_geometry(host.mesh_geometry(host.make.sphere(50.0, nsteps=16)),
                      dev)
    o, d = _rays(128, 5, dev)
    first = _assert_bit_equal(g, o, d)['triangle']
    active = torch.arange(128, device=dev) % 2 == 0
    k = _assert_bit_equal(g, o, d, lht=first, active=active)
    assert (k['triangle'][1::2] == -1).all()


@pytest.mark.cuda
def test_walk_kernel_instanced_tiny(dev):
    tiny = host.demo.tiny()
    tiny.flatten()
    g = pack_geometry(tiny, dev)
    assert g.mbvh_instanced
    k = _assert_bit_equal(g, *_rays(4096, 3, dev))
    assert (k['triangle'] >= 0).float().mean() > 0.9
    # axis-parallel rays: 1/dir = +-inf on two axes
    d = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], dtype=torch.float32,
                     device=dev)
    o = torch.tensor([[0.731, -1.37, 2.113]], device=dev).expand(6, 3)
    _assert_bit_equal(g, o.contiguous(), d)


def _tables(name, dev):
    if name == 'sphere24':
        return pack_geometry(host.mesh_geometry(
            host.make.sphere(50.0, nsteps=24)), dev)
    if name in ('depth1', 'depth2'):
        # 48 triangles are one cluster row; 96 a root and two clusters
        nsteps = 6 if name == 'depth1' else 8
        g = pack_geometry(host.mesh_geometry(
            host.make.sphere(50.0, nsteps=nsteps)), dev)
        assert int(g.mbvh_depth) == int(name[-1])
        return g
    if name == 'ties':
        return pack_geometry(host.tie_geometry(), dev)
    if name == 'ties_instanced':
        return pack_geometry(host.tie_geometry(), dev, instancing=True)
    tiny = host.demo.tiny()
    tiny.flatten()
    return pack_geometry(tiny, dev)


# ray counts at the edges of a warp (one warp walks one ray) and of a
# block (8 rays): 1001 is not a multiple of the block
GROUP_EDGES = [1, 31, 33, 129, 1001]


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['sphere24', 'tiny'])
@pytest.mark.parametrize('n', GROUP_EDGES)
def test_walk_kernel_group_edges(dev, name, n):
    """Ragged ray counts through K1 (flat sphere) and K2 (demo.tiny)."""
    g = _tables(name, dev)
    _assert_bit_equal(g, *_rays(n, 100 + n, dev))


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['ties', 'ties_instanced', 'tiny'])
@pytest.mark.parametrize('od_slots', [1, 2])
def test_window_kernel_axis_rays(dev, name, od_slots):
    """Six lanes walking along the axes (1/dir infinite on two axes),
    restarting on axis-parallel on-deck rays: bit-equal to plain."""
    g = _tables(name, dev)
    depth, inst = int(g.mbvh_depth), bool(g.mbvh_instanced)
    o, d = (torch.from_numpy(a).to(dev) for a in host.axis_rays())
    every = torch.ones(6, dtype=torch.bool, device=dev)
    k = mbvh_walk.window_state(
        g.mbvh_rows, depth, inst, tmbvh.tquant_scale(g), o, d, every,
        [(o, -d, every), (o, d.roll(2, 0), every)][:od_slots])
    p = _clone_state(k)
    seed_args = mbvh_walk.root_seed_args(g)
    for iters in (17, 3000):
        tmbvh.walk_window(g, k, iters, od_slots, *seed_args)
        torch.cuda.synchronize()
        tmbvh.walk_window(g, p, iters, od_slots, *seed_args, plain=True)
        for key in k:
            a, b = k[key], p[key]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (iters, key)
    assert (k['pad'] & 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['ties', 'ties_instanced'])
def test_walk_kernel_ties(dev, name):
    """Twin triangles at equal distances and (instanced) two entries with
    equal boxes, random and axis-parallel rays, and the last-hit skip of
    a twin: the lowest-slot rule decides every tie, as in the plain
    version."""
    g = _tables(name, dev)
    assert g.mbvh_instanced == (name == 'ties_instanced')
    o, d = _rays(300, 8, dev)
    first = _assert_bit_equal(g, o, d)['triangle']
    assert (first >= 0).all()
    _assert_bit_equal(g, o, d, lht=first)
    ao, ad = host.axis_rays()
    _assert_bit_equal(g, torch.from_numpy(ao).to(dev),
                      torch.from_numpy(ad).to(dev))


@pytest.mark.cuda
def test_intersect_mesh_dispatches_to_kernel(dev):
    g = pack_geometry(host.mesh_geometry(host.make.sphere(50.0, nsteps=24)),
                      dev)
    o, d = _rays(64, 1, dev)
    before = mbvh_walk.closest_hit_launches.launches
    tmbvh.intersect_mesh(o, d, g)
    assert mbvh_walk.closest_hit_launches.launches == before + 1


# ---- the on-deck window kernel (K3, K4) and the driver around it ------

def _clone_state(W):
    return mbvh_walk.window_layout({k: v.clone() for k, v in W.items()})


@pytest.mark.cuda
@pytest.mark.parametrize('name,n,od_slots', [
    ('sphere24', 256, 1), ('sphere24', 256, 2), ('tiny', 256, 1),
    ('tiny', 256, 2), ('sphere24', 129, 2), ('tiny', 129, 1),
    ('ties', 256, 1), ('ties_instanced', 256, 2)]
    + [(name, n, od_slots) for name in ('sphere24', 'tiny')
       for n in (1, 31, 33, 1001) for od_slots in (1, 2)])
def test_window_kernel_matches_plain(dev, name, n, od_slots):
    """A service window of 17 iterations, then a long window in which
    every walk drains: every state field bit-equal after each (ragged
    lane counts at the warp and block edges, and the tie scenes)."""
    g = _tables(name, dev)
    depth, inst = int(g.mbvh_depth), bool(g.mbvh_instanced)
    sq = tmbvh.tquant_scale(g)
    seed_args = mbvh_walk.root_seed_args(g)
    k = mbvh_walk.random_window_state(g.mbvh_rows, depth, inst, sq, n,
                                      od_slots, n + od_slots)
    p = _clone_state(k)
    counter = mbvh_walk.walk_window_launches[od_slots]
    for iters in (17, 3000):
        before = counter.launches
        tmbvh.walk_window(g, k, iters, od_slots, *seed_args)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        tmbvh.walk_window(g, p, iters, od_slots, *seed_args, plain=True)
        for key in k:
            a, b = k[key], p[key]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), (iters, key)
    assert not k['act'].any() and (k['lvl'] < 0).all()
    assert n < 32 or ((k['pad'] & 1) != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize('od_slots', [1, 2])
def test_ondeck_driver_kernel_matches_plain(dev, od_slots):
    """The whole on-deck driver on demo.tiny, window kernel against its
    plain version, same generator seed: the final photons bit-equal."""
    from chroma_tpu_torch import gpu
    from chroma_tpu_torch.ops import fused
    g = _tables('tiny', dev)
    np.random.seed(4)
    ph = host.photon_bomb(8192, 400.0, (200.0, 0.0, 0.0)).photons_beg
    outs = []
    for plain in (False, True):
        state = gpu.GPUPhotons(ph, dev).state
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        outs.append(fused.propagate_fused(
            state, g, fused.uniform_draws(gen), max_steps=40, width=2048,
            service_every=17, od_slots=od_slots, plain_walker=plain))
    (k, ks), (p, ps) = outs
    assert torch.equal(ks, ps)
    for key in k:
        a, b = k[key], p[key]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), key


@pytest.mark.cuda
def test_referee_terminal_passthrough_on_card(dev):
    from chroma_tpu_torch import referee
    g = _tables('tiny', dev)
    for od_slots in (1, 2):
        assert referee.terminal_passthrough(g, od_slots=od_slots) == []


@pytest.mark.cuda
@pytest.mark.parametrize('gate', host.GATES)
def test_gate_box_on_card(dev, gate):
    """Each gated physics model in its gate box through the on-deck
    driver on the card: one-step outcome shares against the specified
    probabilities and the weighted detection sum against the unweighted
    count, within 5 sigma; the window kernel launched (flat tables: K1's
    on-deck variant)."""
    from chroma_tpu_torch import referee
    counter = mbvh_walk.walk_window_launches[1]
    before = counter.launches
    results = referee.gate_box_checks(gate, dev, n=100000, seed=7)
    assert counter.launches > before
    for what, observed, expected, sigma in results:
        assert abs(observed - expected) <= 5.0 * sigma, \
            (what, observed, expected, sigma)


@pytest.mark.cuda
def test_eval_pdf_and_tracking_on_card(dev):
    """One ``eval_pdf`` through ``Likelihood`` on demo.tiny on the card
    (weighted on-deck propagation, DAQ at ndaq 8, variable-bin PDF), and
    tracking mode against the step loop, bit for bit."""
    from chroma_tpu_torch import gpu
    from chroma_tpu_torch.likelihood import Likelihood
    from chroma_tpu_torch.sim import Simulation
    sim = Simulation(host.demo.tiny(), seed=5, device=dev)
    pos = (200.0, 0.0, 0.0)
    np.random.seed(6)
    ev = next(sim.simulate(host.photon_bomb(20000, 400.0, pos).photons_beg,
                           run_daq=True))
    assert ev.channels.hit.sum() > 10

    def bombs():
        while True:
            yield host.photon_bomb(20000, 400.0, pos).photons_beg

    before = mbvh_walk.walk_window_launches[1].launches
    lik = Likelihood(sim, event=ev, trange=(-0.5, 99.5))
    hit_prob, pdf_prob, _ = lik.eval_channel_vbin(bombs(), 1, nreps=2,
                                                  ndaq=8, min_bin_content=10)
    assert mbvh_walk.walk_window_launches[1].launches > before
    assert np.isfinite(pdf_prob).all() and hit_prob.max() > 0.2
    nll = lik.eval(bombs(), nevals=1, nreps=2, ndaq=8)
    assert np.isfinite(nll.nominal_value)

    ph = host.photon_bomb(4096, 400.0, pos).photons_beg
    tracked, stepped = gpu.GPUPhotons(ph, dev), gpu.GPUPhotons(ph, dev)
    before = mbvh_walk.closest_hit_launches.launches
    _, snaps = tracked.propagate(sim.gpu_geometry,
                                 gpu.get_rng_states(seed=3, device=dev),
                                 max_steps=30, track=True)
    assert mbvh_walk.closest_hit_launches.launches - before \
        == tracked.last_steps == len(snaps) - 1
    stepped.propagate(sim.gpu_geometry,
                      gpu.get_rng_states(seed=3, device=dev), max_steps=30,
                      driver='steps')
    for key, v in stepped.state.items():
        assert torch.equal(tracked.state[key], v), key


# ---- the window without on-deck slots (K5) and K6 on it ----------------

def _assert_state_equal(k, p, what):
    for key in k:
        a, b = k[key], p[key]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (what, key)


def _k5_window(g, k, p, iters, prune):
    """One window of ``iters`` iterations, the K5 kernel on ``k`` and the
    plain version on ``p``: one launch counted, every state field bit-equal
    and the active lane-iterations equal.  Returns the count."""
    seed_args = mbvh_walk.root_seed_args(g)
    counter = mbvh_walk.walk_window_launches[mbvh_walk.window_key(0, prune)]
    ck = torch.zeros((), dtype=torch.int64, device=k['act'].device)
    cp = torch.zeros_like(ck)
    before = counter.launches
    tmbvh.walk_window(g, k, iters, 0, *seed_args, prune=prune, nactive=ck)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    tmbvh.walk_window(g, p, iters, 0, *seed_args, prune=prune, plain=True,
                      nactive=cp)
    _assert_state_equal(k, p, iters)
    assert int(ck) == int(cp), iters
    return int(ck)


def _k5_state(g, n, seed):
    return mbvh_walk.random_window_state(
        g.mbvh_rows, int(g.mbvh_depth), bool(g.mbvh_instanced),
        tmbvh.tquant_scale(g), n, 0, seed)


K5_CASES = ([(name, 256) for name in ('sphere24', 'tiny', 'ties',
                                      'ties_instanced', 'depth1', 'depth2')]
            + [(name, n) for name in ('sphere24', 'tiny')
               for n in GROUP_EDGES])


@pytest.mark.cuda
@pytest.mark.parametrize('prune', [True, False])
@pytest.mark.parametrize('name,n', K5_CASES)
def test_k5_kernel_matches_plain(dev, name, n, prune):
    """K5 (csrc/mbvh_walk_window_k5.cu) against the plain window: one
    iteration, a service window of 17, then a long window in which every
    walk drains; ragged widths, the tie scenes, depth-1 and depth-2
    trees, both prune flags."""
    g = _tables(name, dev)
    k = _k5_state(g, n, n + 7)
    p = _clone_state(k)
    for iters in (1, 17, 3000):
        _k5_window(g, k, p, iters, prune)
    assert not k['act'].any() and (k['lvl'] < 0).all()
    assert (k['tri'] >= 0).any() or n < 32


@pytest.mark.cuda
@pytest.mark.parametrize('prune', [True, False])
@pytest.mark.parametrize('delta', [-1, 1])
@pytest.mark.parametrize('name', ['sphere24', 'tiny'])
def test_k5_kernel_around_the_persistent_grid(dev, name, delta, prune):
    """One lane fewer and one more than the persistent grid has warps:
    every warp takes one lane, or one warp takes a second."""
    g = _tables(name, dev)
    warps = mbvh_walk.k5_persistent_warps(g)
    assert warps >= torch.cuda.get_device_properties(
        dev).multi_processor_count * 16
    n = warps + delta
    k = _k5_state(g, n, 41)
    p = _clone_state(k)
    for iters in (1, 17):
        _k5_window(g, k, p, iters, prune)


def _drain(g, W, prune):
    tmbvh.walk_window(g, W, 3000, 0, *mbvh_walk.root_seed_args(g),
                      prune=prune, plain=True)
    assert not W['act'].any() and (W['lvl'] < 0).all()
    return W


@pytest.mark.cuda
@pytest.mark.parametrize('prune', [True, False])
@pytest.mark.parametrize('name', ['sphere24', 'tiny', 'depth1'])
def test_k5_kernel_leaves_drained_lanes_alone(dev, name, prune):
    """Every lane drained: a window changes no byte of the state and
    counts no active iteration."""
    g = _tables(name, dev)
    k = _drain(g, _k5_state(g, 1001, 9), prune)
    before = _clone_state(k)
    p = _clone_state(k)
    for iters in (1, 17):
        assert _k5_window(g, k, p, iters, prune) == 0
        _assert_state_equal(k, before, 'drained')


@pytest.mark.cuda
@pytest.mark.parametrize('prune', [True, False])
@pytest.mark.parametrize('name', ['sphere24', 'tiny', 'ties_instanced'])
def test_k5_kernel_mixed_lanes(dev, name, prune):
    """A third of the lanes drained at entry, the rest walking or seeded
    inactive: bit-equal to plain at n_iters 1 and 17, and the drained
    lanes untouched."""
    g = _tables(name, dev)
    n = 1001
    fresh = _k5_state(g, n, 13)
    done = _drain(g, _clone_state(fresh), prune)
    lanes = torch.arange(n, device=dev) % 3 == 0
    k = mbvh_walk.window_layout({
        key: torch.where(lanes.view((n,) + (1,) * (v.dim() - 1)),
                         done[key], v) for key, v in fresh.items()})
    start = _clone_state(k)
    p = _clone_state(k)
    for iters in (1, 17):
        _k5_window(g, k, p, iters, prune)
    for key, v in start.items():
        assert torch.equal(k[key][lanes], v[lanes]), key


# ---- the physics kernel (csrc/physics_step.cu) --------------------------

@pytest.fixture(scope='module')
def physics_tables(dev):
    return {name: pack_geometry(make(), dev)
            for name, make in torch_scenes.SCENES.items()}


def _assert_physics_equal(k, p, what):
    """Every field bit-equal (floats by their bits), or the photons that
    differ named."""
    for key in p:
        a, b = k[key], p[key]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        bad = (a != b).reshape(a.shape[0], -1).any(dim=1)
        assert not bad.any(), (what, key, int(bad.sum()),
                               torch.nonzero(bad)[:8, 0].tolist())


# outcomes a batch of ``torch_scenes.physics_inputs`` reaches in each
# scene without forced scattering or weights, so that the comparison
# covers them
PHYSICS_OUTCOMES = {
    'water': ('NO_HIT', 'BULK_ABSORB', 'RAYLEIGH_SCATTER', 'SURFACE_ABSORB',
              'SURFACE_DETECT', 'REFLECT_DIFFUSE'),
    'scint': ('NO_HIT', 'BULK_ABSORB', 'BULK_REEMIT', 'RAYLEIGH_SCATTER',
              'SURFACE_ABSORB'),
    'mixed': ('NO_HIT', 'BULK_ABSORB', 'RAYLEIGH_SCATTER', 'SURFACE_ABSORB',
              'SURFACE_DETECT', 'REFLECT_DIFFUSE', 'REFLECT_SPECULAR'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('use_weights', [False, True])
@pytest.mark.parametrize('scatter_first', [0, 1, -1, 'per_photon'])
@pytest.mark.parametrize('scene', sorted(torch_scenes.SCENES))
def test_physics_kernel_matches_plain(dev, physics_tables, scene,
                                      scatter_first, use_weights):
    """``physics_update`` through csrc/physics_step.cu against
    ``physics_update_plain`` on one batch that mixes live, dead,
    NaN-aborted, incomplete and missing photons (a ragged 40,001): every
    output field bit-equal, one launch."""
    from chroma_tpu_torch import event
    from chroma_tpu_torch.ops import propagate
    tables = physics_tables[scene]
    n = 40001
    args = torch_scenes.physics_inputs(tables, n, 11, dev)
    sf = scatter_first
    if sf == 'per_photon':
        sf = torch.from_numpy(np.random.RandomState(5).randint(
            -1, 2, n).astype(np.int32)).to(dev)
    before = propagate.physics_launches.launches
    k = propagate.physics_update(*args, sf, use_weights=use_weights)
    torch.cuda.synchronize()
    assert propagate.physics_launches.launches == before + 1
    p = propagate.physics_update_plain(*args, sf, use_weights=use_weights)
    assert propagate.physics_launches.launches == before + 1
    _assert_physics_equal(k, p, (scene, scatter_first, use_weights))
    assert k['evidx'] is args[0]['evidx'] and k['index'] is args[0]['index']
    if scatter_first == 0 and not use_weights:
        # forced scattering and weights take most of the surface
        # outcomes away; here every outcome the scene holds occurs
        flags = p['flags']
        for name in PHYSICS_OUTCOMES[scene]:
            assert ((flags & getattr(event, name)) != 0).sum() > 20, name


@pytest.mark.cuda
@pytest.mark.parametrize('driver', ['steps', 'fused'])
@pytest.mark.parametrize('scene', ['scint', 'mixed'])
def test_propagation_with_physics_kernel_matches_plain(dev, scene, driver,
                                                      monkeypatch):
    """A whole propagation of 20,000 photons, with forced first scattering
    (the lane-pool driver hands the kernel a per-photon scatter_first):
    the kernel's final photons bit-equal to the plain physics'."""
    from chroma_tpu_torch import gpu
    from chroma_tpu_torch.ops import propagate
    det = gpu.GPUDetector(torch_scenes.SCENES[scene](), dev)
    np.random.seed(8)
    ph = host.photon_bomb(20000, 420.0, (0.0, -200.0, 0.0)).photons_beg

    def run():
        gp = gpu.GPUPhotons(ph, dev)
        gp.propagate(det, gpu.get_rng_states(seed=4, device=dev),
                     driver=driver, scatter_first=1, width=4096)
        return gp.state

    before = propagate.physics_launches.launches
    k = run()
    assert propagate.physics_launches.launches > before
    monkeypatch.setattr(propagate, 'kernel_serves', lambda *a: False)
    before = propagate.physics_launches.launches
    p = run()
    assert propagate.physics_launches.launches == before
    _assert_physics_equal(k, p, (scene, driver))


@pytest.mark.cuda
def test_physics_kernel_counts_and_gated_models(dev):
    """On the card the step loop's physics runs in the kernel: the
    counter ``step.physics_kernel_photons`` equals ``step.live_photons``
    and no ``step.reemit`` opens in the scintillator.  A gate box with a
    WLS, dichroic or thin-film surface keeps the plain path: the counter
    stays at 0 and the kernel does not launch."""
    from chroma_tpu_torch import gpu, tracing
    from chroma_tpu_torch.ops import propagate
    np.random.seed(9)
    ph = host.photon_bomb(5000, 400.0, (0.0, 0.0, 0.0)).photons_beg
    det = gpu.GPUDetector(torch_scenes.scint_scene(), dev)
    with tracing.recording() as rec:
        gpu.GPUPhotons(ph, dev).propagate(
            det, gpu.get_rng_states(seed=3, device=dev), driver='steps')
    assert rec.counts['step.physics_kernel_photons'] \
        == rec.counts['step.live_photons'] > 5000
    names = {name for name, _, _, _ in rec.spans}
    assert 'step.physics' in names and 'step.reemit' not in names
    for gate in ('wls', 'dichroic', 'complex'):
        geo = gpu.GPUGeometry(host.gate_box(gate), dev)
        before = propagate.physics_launches.launches
        with tracing.recording() as rec:
            gpu.GPUPhotons(ph, dev).propagate(
                geo, gpu.get_rng_states(seed=3, device=dev), driver='steps')
        assert rec.counts.get('step.physics_kernel_photons', 0) == 0, gate
        assert rec.counts['step.live_photons'] > 0, gate
        assert propagate.physics_launches.launches == before, gate


@pytest.mark.cuda
def test_physics_kernel_wrapper_refuses(dev, physics_tables):
    """The wrapper checks what the kernel reads: a float or 2-d
    scatter_first, a draw block of the wrong width, and tables with a
    WLS surface raise before any launch."""
    import dataclasses
    from chroma_tpu_torch.ops import propagate
    tables = physics_tables['water']
    state, res, _, u, flags, active, nan_mask = \
        torch_scenes.physics_inputs(tables, 64, 3, dev)
    for sf in (torch.zeros(64, device=dev),
               torch.zeros((64, 1), dtype=torch.int32, device=dev)):
        with pytest.raises(ValueError, match='scatter_first'):
            propagate.physics_update_cuda(state, res, tables, u, flags,
                                          active, nan_mask, sf)
    with pytest.raises(ValueError, match='arg u'):
        propagate.physics_update_cuda(state, res, tables, u[:, :19], flags,
                                      active, nan_mask)
    with pytest.raises(ValueError, match='WLS'):
        propagate.physics_update_cuda(
            state, res, dataclasses.replace(tables, has_wls=True), u, flags,
            active, nan_mask)
    # a 0-d scatter_first applies to every photon
    one = propagate.physics_update_cuda(state, res, tables, u, flags, active,
                                        nan_mask, 1)
    zero_d = propagate.physics_update_cuda(
        state, res, tables, u, flags, active, nan_mask,
        torch.tensor(1, device=dev))
    _assert_physics_equal(one, zero_d, '0-d scatter_first')
