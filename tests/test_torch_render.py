"""The port's rendering path against the JAX package's: ``from_film``,
``render``, ``GPURays``, ``color_solids``, ``Camera``/``EventViewer`` and
the hybrid photon-map renderer, all on the CPU.

On the CPU the JAX ``intersect_mesh`` is its jnp cascade and the port's
is the plain version of the Pallas walk: triangle ids agree except on
exact ties and floats differ by FMA contraction (<= 2e-5), so pixels are
compared with a tolerance: within 2 of 255 in every channel on >= 99.5%
of pixels.  Ray transforms agree within 1e-5; ``from_film`` and colours
are exact.  The hybrid renderer draws different random numbers in the two
packages and is compared statistically (5 sigma over 8 seeds).
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax.numpy as jnp
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu import demo as jdemo, gpu as jgpu, make as jmake
from chroma_tpu.geometry import Geometry as JGeometry, Solid as JSolid, \
    Surface as JSurface, vacuum as jvacuum
from chroma_tpu.loader import create_geometry_from_obj as jcreate
from chroma_tpu.ops import render as jrender
from chroma_tpu.tools import from_film as jfrom_film
from chroma_tpu_torch import gpu, host
from chroma_tpu_torch.camera import Camera, EventViewer, pixels_to_rgb_array
from chroma_tpu_torch.geometry import Surface
from chroma_tpu_torch.loader import create_geometry_from_obj
from chroma_tpu_torch.ops import render as prender
from chroma_tpu_torch.ops.hybrid import HybridRenderer, to_diffuse
from chroma_tpu_torch.tools import from_film

SIZE = (64, 48)


def _rgb(pixels):
    pixels = np.asarray(pixels).astype(np.int64)
    return np.stack([(pixels >> 16) & 0xFF, (pixels >> 8) & 0xFF,
                     pixels & 0xFF], axis=-1)


def _close_share(a, b):
    return (np.abs(_rgb(a) - _rgb(b)) <= 2).all(axis=-1).mean()


@pytest.mark.parametrize('kw', [
    dict(position=(0.0, -500.0, 0.0), size=SIZE),
    dict(position=(10.0, 20.0, -30.0), axis1=(0, 1, 1), axis2=(1, 0, 0),
         size=(17, 9), width=20.0, focal_length=50.0)])
def test_from_film_bit_equal(kw):
    for a, b in zip(jfrom_film(**kw), from_film(**kw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _sphere(mod_geometry, mod_solid, mod_make, vac, color=0x00ff0000):
    geo = mod_geometry(vac)
    geo.add_solid(mod_solid(mod_make.sphere(100.0, nsteps=24), vac, vac,
                            color=color))
    return geo


@pytest.fixture(scope='module')
def scenes():
    """{name: (JAX tables, port tables, viewpoint)} of the sphere and of
    demo.tiny, each built by its own package."""
    jsphere = jcreate(_sphere(JGeometry, JSolid, jmake, jvacuum),
                      update_bvh_cache=False)
    psphere = _sphere(host.Geometry, host.Solid, host.make, host.vacuum)
    psphere.flatten()
    jtiny = jdemo.tiny()
    jtiny.flatten()
    ptiny = host.demo.tiny()
    ptiny.flatten()
    # demo.tiny is viewed from its center.  ``render`` steps 1e-3 mm
    # past each hit; from outside the detector a hit lies metres away,
    # where that step is near the float32 resolution of the distance, so
    # whether a ray meets again the surface it just left is decided by
    # rounding, and the two walkers' floats differ in the last bits.
    lower, upper = ptiny.mesh.get_bounds()
    view = 0.5 * (lower + upper)
    return {'sphere': (jgpu.GPUGeometry(jsphere),
                       gpu.GPUGeometry(psphere, 'cpu'),
                       (0.0, -500.0, 0.0)),
            'tiny': (jgpu.GPUDetector(jtiny), gpu.GPUDetector(ptiny, 'cpu'),
                     view)}


@pytest.mark.parametrize('name', ['sphere', 'tiny'])
def test_render_matches_jax(scenes, name):
    """64x48 rays, alpha_depth 10, through both packages' ``render``."""
    jgg, pgg, view = scenes[name]
    pos, dirs = from_film(view, size=SIZE)
    jpix = np.asarray(jrender.render(jnp.asarray(pos, jnp.float32),
                                     jnp.asarray(dirs, jnp.float32),
                                     jgg.geom))
    ppix = prender.render(torch.from_numpy(pos.astype(np.float32)),
                          torch.from_numpy(dirs.astype(np.float32)),
                          pgg.geom)
    assert ppix.dtype == torch.int64 and ppix.shape == (SIZE[0] * SIZE[1],)
    ppix = ppix.numpy()
    assert ppix.min() >= 0xFF000000 and ppix.max() <= 0xFFFFFFFF
    assert (ppix != 0xFF666666).any()
    assert _close_share(jpix, ppix) >= 0.995


def test_render_sphere_silhouette(scenes):
    """The shape of tests/test_render.py's silhouette test, and a ray that
    misses (distance inf) leaves no NaN behind."""
    _, pgg, view = scenes['sphere']
    pos, dirs = from_film(view, size=SIZE)
    rays = prender.GPURays(pos, dirs, device='cpu')
    pixels = rays.snapshot(pgg)
    assert pixels.dtype == np.uint32
    img = pixels.reshape(SIZE[0], SIZE[1])
    center = int(img[SIZE[0] // 2, SIZE[1] // 2])
    assert (center >> 16) & 0xFF > 100 and center & 0xFF < 50
    assert int(img[0, 0]) == 0xFF666666


def test_gpurays_transforms_match_jax():
    rng = np.random.RandomState(2)
    pos = rng.normal(size=(50, 3)) * 100.0
    dirs = rng.normal(size=(50, 3))
    jr = jrender.GPURays(pos, dirs)
    pr = prender.GPURays(pos, dirs, device='cpu')
    for rays in (jr, pr):
        rays.rotate(0.7, (0.0, 0.0, 1.0))
        rays.translate((1.0, -2.0, 3.0))
        rays.rotate_around_point(-1.1, (0.6, 0.0, 0.8), (10.0, 20.0, 30.0))
    # positions of order 100 in float32: 1e-5 relative
    np.testing.assert_allclose(pr.pos.numpy(), np.asarray(jr.pos),
                               rtol=1e-5, atol=1e-5 * 100.0)
    np.testing.assert_allclose(pr.dir.numpy(), np.asarray(jr.dir),
                               rtol=1e-5, atol=1e-5)
    one = prender.GPURays([[1.0, 0, 0]], [[0, 1.0, 0]], device='cpu')
    one.rotate(np.pi / 2, (0, 0, 1.0))
    np.testing.assert_allclose(one.pos.numpy(), [[0, -1, 0]], atol=1e-6)


def _two_cubes(mod_geometry, mod_solid, mod_make, vac):
    geo = mod_geometry(vac)
    geo.add_solid(mod_solid(mod_make.cube(1.0), vac, vac, color=0x111111))
    geo.add_solid(mod_solid(mod_make.cube(1.0), vac, vac, color=0x80222222),
                  displacement=(5, 0, 0))
    return geo


def test_color_solids_matches_jax():
    """Colours with the top bit set survive the int32 table; the result
    equals the JAX package's as uint32."""
    jgeo = jcreate(_two_cubes(JGeometry, JSolid, jmake, jvacuum),
                   update_bvh_cache=False)
    pgeo = _two_cubes(host.Geometry, host.Solid, host.make, host.vacuum)
    pgeo.flatten()
    jgg, pgg = jgpu.GPUGeometry(jgeo), gpu.GPUGeometry(pgeo, 'cpu')
    args = (np.array([False, True]),
            np.array([0, 0xFFABCDEF], np.uint32))
    jgg.color_solids(*args)
    pgg.color_solids(*args)
    pcolors = pgg.geom.colors.numpy().view(np.uint32)
    assert pgg.geom.colors.dtype == torch.int32
    assert np.array_equal(pcolors, np.asarray(jgg.geom.colors))
    nt = len(pgeo.mesh.triangles)
    assert (pcolors[:nt // 2] == 0x111111).all()
    assert (pcolors[nt // 2:] == 0xFFABCDEF).all()
    assert pgg.device_usage_str().startswith('geometry tables: ')


def _ball():
    geo = host.Geometry(host.vacuum)
    geo.add_solid(host.Solid(host.make.sphere(500.0, nsteps=12),
                             host.vacuum, host.vacuum))
    return geo


def test_camera_snapshot_and_array(tmp_path):
    from PIL import Image
    geo = host.Geometry(host.vacuum)
    geo.add_solid(host.Solid(host.make.cube(100.0), host.vacuum,
                             host.vacuum, color=0x3300ff00))
    cam = Camera(geo, size=(40, 30), device='cpu')
    arr = cam.render_to_array()
    assert arr.shape == (30, 40, 3) and arr.dtype == np.uint8
    assert np.array_equal(arr, pixels_to_rgb_array(cam.render_pixels(),
                                                   (40, 30)))
    path = str(tmp_path / 'snap.png')
    cam.snapshot(path)
    assert Image.open(path).size == (40, 30)


def test_camera_takes_tables_already_on_a_device():
    """A GPUGeometry is used as it is (not packed again); tables without
    a host geometry are framed by their own vertices."""
    geo = _ball()
    geo.flatten()
    gg = gpu.GPUGeometry(geo, 'cpu')
    cam = Camera(gg, size=(40, 30))
    assert cam.gpu_geometry is gg and cam.device.type == 'cpu'
    bare = gpu.GPUGeometry(geo, 'cpu')
    bare.geometry = None
    cam2 = Camera(bare, size=(40, 30))
    np.testing.assert_allclose(cam2.viewpoint, cam.viewpoint, rtol=1e-6)
    assert np.array_equal(cam2.render_to_array(), cam.render_to_array())


def test_camera_bvh_wireframe_and_anaglyph():
    geo = create_geometry_from_obj(_ball(), update_bvh_cache=False)
    cam = Camera(geo, size=(120, 90), device='cpu')
    plain = cam.render_to_array()
    wire = cam.render_bvh_to_array(layer=1)
    assert (wire != plain).any()
    ana = cam.render_anaglyph_to_array()
    assert ana.shape == plain.shape
    # red channel comes from a shifted eye: differs from mono render
    assert (ana[..., 0] != plain[..., 0]).any()


def test_bvh_layers_unpack_like_jax():
    """``unpack_nodes`` and ``BVH.get_layer``, which the wireframe reads."""
    from chroma_tpu.bvh.bvh import unpack_nodes as junpack
    from chroma_tpu_torch.bvh.bvh import unpack_nodes
    geo = create_geometry_from_obj(_ball(), update_bvh_cache=False)
    bvh = geo.bvh
    assert sum(len(bvh.get_layer(i)) for i in range(bvh.layer_count())) \
        == len(bvh)
    layer = bvh.get_layer(bvh.layer_count() - 1)
    a, b = unpack_nodes(layer.nodes), junpack(layer.nodes)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_camera_rotate_consistency():
    """A full orbit returns the viewpoint and the frame to their start."""
    geo = _ball()
    cam = Camera(geo, size=(60, 45), device='cpu')
    start = cam.viewpoint.copy()
    frame = cam.render_to_array()
    for i in range(8):
        cam.rotate(np.pi / 4, np.array([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(cam.viewpoint, start, atol=1e-6)
    again = cam.render_to_array()
    assert (np.abs(again.astype(int) - frame.astype(int)) <= 2).mean() > 0.99


def test_event_viewer_track_overlay(tmp_path):
    """EventViewer snapshot with photon-track overlay: tracks must
    visibly change the rendered image; channels recolour the PMT."""
    from PIL import Image
    from chroma_tpu_torch.detector import Detector
    from chroma_tpu_torch.demo.optics import water, \
        r7081hqe_photocathode, black_surface
    from chroma_tpu_torch.sim import Simulation
    det = Detector(water)
    det.add_solid(host.Solid(host.make.sphere(1000.0, nsteps=16), water,
                             water, surface=black_surface))
    det.add_pmt(host.Solid(host.make.cube(200.0), water, water,
                           surface=r7081hqe_photocathode),
                displacement=(0, 0, 600.0))
    det.set_time_dist_gaussian(1.5, -7.5, 7.5)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.0, 1.5)
    sim = Simulation(det, seed=3, photon_tracking=True, device='cpu')
    np.random.seed(3)
    ev = next(sim.simulate([host.photon_bomb(60, 400, (0, 0, 0))],
                           run_daq=True))
    assert ev.photon_tracks is not None and len(ev.photon_tracks) == 60

    before = sim.gpu_geometry.geom.colors.clone()
    viewer = EventViewer(sim.gpu_geometry, [ev], size=(160, 120))
    assert viewer.gpu_geometry is sim.gpu_geometry
    if ev.channels.hit.any():
        assert (sim.gpu_geometry.geom.colors != before).any()
    plain = viewer.render_to_array()
    overlaid = viewer.render_event_to_array(ev)
    assert overlaid.shape == plain.shape
    assert (overlaid != plain).any()

    path = str(tmp_path / 'event.png')
    viewer.snapshot_event(path)
    assert np.asarray(Image.open(path)).shape == (120, 160, 3)


# ---- the hybrid photon-map renderer -----------------------------------

NSEEDS = 8
NLOOKUP = 4


def _diffuse_box(mod_geometry, mod_solid, mod_make, mod_surface, water):
    diffuse = mod_surface('diffuse_wall')
    diffuse.set('reflect_diffuse', 0.7)
    diffuse.set('absorb', 0.3)
    geo = mod_geometry(water)
    geo.add_solid(mod_solid(mod_make.cube(2000.0), water, water,
                            surface=diffuse))
    return geo


def test_hybrid_lookup_matches_jax_statistically():
    """A diffuse box lit from inside (tests/test_render.py): the summed
    irradiance each package's ``update_xyz_lookup`` collects on each lit
    side, NLOOKUP passes a seed over NSEEDS seeds, within 5 sigma of the
    other's (standard errors of the two means); the image is finite and
    non-zero."""
    from chroma_tpu.demo.optics import water as jwater
    from chroma_tpu.ops.hybrid import HybridRenderer as JHybridRenderer
    from chroma_tpu_torch.demo.optics import water
    jgeo = jcreate(_diffuse_box(JGeometry, JSolid, jmake, JSurface, jwater),
                   update_bvh_cache=False)
    pgeo = _diffuse_box(host.Geometry, host.Solid, host.make, Surface,
                        water)
    pgeo.flatten()
    jgg, pgg = jgpu.GPUGeometry(jgeo), gpu.GPUGeometry(pgeo, 'cpu')
    source = (150.0, -80.0, 40.0)

    sums = {}
    for name, cls, gg in (('jax', JHybridRenderer, jgg),
                          ('port', HybridRenderer, pgg)):
        per_seed = []
        for seed in range(NSEEDS):
            hyb = cls(gg, max_steps=6, seed=seed)
            for _ in range(NLOOKUP):
                hyb.update_xyz_lookup(source, chunk=1 << 12)
            assert hyb.nlookup_calls == NLOOKUP
            per_seed.append([float(np.asarray(t).sum()) for t in hyb.lookup])
        sums[name] = np.array(per_seed)                 # (NSEEDS, 2)
    assert sums['port'].sum() > 0.0
    for side in (0, 1):
        j, p = sums['jax'][:, side], sums['port'][:, side]
        sigma = np.sqrt((j.var(ddof=1) + p.var(ddof=1)) / NSEEDS)
        assert abs(j.mean() - p.mean()) <= 5.0 * sigma + 1e-9, \
            (side, j.mean(), p.mean(), sigma)

    lookup = [t.numpy() for t in hyb.lookup]
    assert all(np.isfinite(t).all() and (t >= 0).all() for t in lookup)
    pos, dirs = from_film((0.0, -900.0, 0.0), size=(32, 24))
    img = hyb.render(torch.from_numpy(pos.astype(np.float32)),
                     torch.from_numpy(dirs.astype(np.float32))).numpy()
    assert img.shape == (32 * 24, 3)
    assert np.isfinite(img).all() and img.max() > 0.0
    pixels = hyb.process_image(img, scale=1.0 / max(img.max(), 1e-9))
    assert pixels.shape == (32 * 24,) and pixels.dtype == np.uint32
    hyb.clear_lookup()
    assert hyb.nlookup_calls == 0 and float(hyb.lookup[0].sum()) == 0.0


def test_to_diffuse_stops_at_the_first_diffuse_reflection():
    """Every photon sent at the wall of the diffuse box from inside ends
    diffusely reflected or absorbed at its first hit; the triangle is the
    one it was sent to and the lit side is the same for all of them."""
    from chroma_tpu_torch import event
    from chroma_tpu_torch.demo.optics import water
    from chroma_tpu_torch.ops.propagate import make_photon_state
    pgeo = _diffuse_box(host.Geometry, host.Solid, host.make, Surface,
                        water)
    pgeo.flatten()
    gg = gpu.GPUGeometry(pgeo, 'cpu')
    n = 600
    np.random.seed(6)
    ph = host.photon_bomb(n, 545.0, (0.0, 0.0, 0.0)).photons_beg
    state = make_photon_state(pos=ph.pos, dir=ph.dir, pol=ph.pol,
                              wavelength=ph.wavelengths, t=ph.t,
                              device='cpu')
    gen = torch.Generator(device='cpu')
    gen.manual_seed(1)
    diffuse, tri, outward = to_diffuse(state, gg.geom, gen, max_steps=6)
    share = float(diffuse.float().mean())
    # reflect_diffuse 0.7 of n = 600: 5 sigma is 0.094
    assert abs(share - 0.7) < 0.094
    assert bool((tri[diffuse] >= 0).all()) and bool((tri[~diffuse] == -1).all())
    assert len(set(outward[diffuse].tolist())) == 1
    assert state['flags'].dtype == torch.int32
    assert event.REFLECT_DIFFUSE > 0
