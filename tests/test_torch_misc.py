"""The port's last host modules against the JAX package's, on the same
inputs, in the shapes of tests/test_misc.py and tests/test_referee.py:
``histogram`` (Histogram, HistogramDD, Graph), ``parabola``, ``color``,
``tools``, the PMT builders of ``pmt``, ``referee.run_referee``,
``gpu.create_cuda_context`` and the package's top-level names.  Every
comparison is exact: these are the same numpy operations on the same
arrays."""
import sys

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax  # noqa: F401  (imported before torch, as the test files do)
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

import chroma_tpu
import chroma_tpu_torch
from chroma_tpu import color as jcolor, parabola as jparabola
from chroma_tpu import pmt as jpmt, referee as jreferee, tools as jtools
from chroma_tpu.histogram import (Graph as JGraph, Histogram as JHistogram,
                                  HistogramDD as JHistogramDD)
from chroma_tpu_torch import color, gpu, host, parabola, pmt, referee, tools
from chroma_tpu_torch.histogram import Graph, Histogram, HistogramDD


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and np.array_equal(a, b, equal_nan=a.dtype.kind == 'f')


def test_histograms_match_jax():
    rng = np.random.RandomState(0)
    x = rng.normal(5.0, 2.0, 500)
    h, jh = Histogram(10, (0, 10)), JHistogram(10, (0, 10))
    for hist in (h, jh):
        hist.fill(x)
        hist.fill([0.5, 1.5, 1.6, 9.5])
    assert _same(h.hist, jh.hist) and _same(h.errs, jh.errs)
    assert _same(h.bins, jh.bins) and h.nentries == jh.nentries
    assert h.ueval(1.55) == jh.ueval(1.55)
    h.normalize()
    jh.normalize()
    assert _same(h.hist, jh.hist) and _same(h.errs, jh.errs)

    pts = rng.uniform(0, 5, (300, 2))
    h, jh = (cls((5, 4), range=((0, 5), (0, 5)))
             for cls in (HistogramDD, JHistogramDD))
    for hist in (h, jh):
        hist.fill(pts)
        hist.fill([[0.5, 0.5], [0.5, 0.5], [4.5, 4.5]])
    assert _same(h.hist, jh.hist) and _same(h.errs, jh.errs)
    assert all(_same(a, b) for a, b in zip(h.bins, jh.bins))
    assert all(_same(a, b) for a, b in zip(h.bincenters, jh.bincenters))
    for p in ((4.7, 4.7), (0.1, 2.2), (9.0, -1.0)):
        assert h.findbin(p) == jh.findbin(p)
        assert h.ueval(p) == jh.ueval(p)
    h.scale(-2.0)
    jh.scale(-2.0)
    h.normalize()
    jh.normalize()
    assert _same(h.hist, jh.hist) and _same(h.errs, jh.errs)
    h.reset()
    assert h.nentries == 0 and not h.hist.any()

    g, jg = (cls([1, 2, 3], [4.0, 5.0, 6.5], yerr=[0.1, 0.2, 0.3])
             for cls in (Graph, JGraph))
    for f in ('x', 'y', 'xerr', 'yerr'):
        assert _same(getattr(g, f), getattr(jg, f)), f
    assert g.size() == jg.size() == 3
    with pytest.raises(ValueError):
        Graph([1, 2], [1])


def test_parabola_matches_jax():
    """The exact parabola of tests/test_misc.py, with errors: every
    output of the fit, the evaluation and the minimum equal to the JAX
    package's, and the fit exact (1e-6)."""
    rng = np.random.RandomState(0)
    A = np.array([[2.0, 0.3], [0.3, 1.0]])
    b = np.array([1.0, -2.0])
    c = 5.0
    x = rng.uniform(-3, 3, (50, 2))
    y = c + x @ b + np.einsum('ni,ij,nj->n', x, A, x)
    yerr = rng.uniform(0.5, 1.5, 50)
    for args in ((x, y), (x, y, yerr)):
        got = parabola.parabola_fit(*args)
        want = jparabola.parabola_fit(*args)
        for g, w in zip(got, want):
            assert _same(g, w)
    c2, b2, A2 = got[:3]
    assert c2 == pytest.approx(c, abs=1e-6)
    np.testing.assert_allclose(A2, A, atol=1e-6)
    assert _same(parabola.build_design_matrix(x),
                 jparabola.build_design_matrix(x))
    assert _same(parabola.parabola_eval(x[:7], c2, b2, A2),
                 jparabola.parabola_eval(x[:7], c2, b2, A2))
    xmin, ymin = parabola.minimum(c2, b2, A2)
    jxmin, jymin = jparabola.minimum(c2, b2, A2)
    assert _same(xmin, jxmin) and ymin == jymin
    np.testing.assert_allclose(b + 2 * A @ xmin, 0.0, atol=1e-6)


def test_colors_match_jax():
    wl = np.linspace(300.0, 800.0, 101)
    assert _same(color.map_wavelength(wl), jcolor.map_wavelength(wl))
    from chroma_tpu_torch.color import chromaticity
    from chroma_tpu.color import chromaticity as jchromaticity
    assert _same(chromaticity.cie_xyz(wl), jchromaticity.cie_xyz(wl))
    rgb = color.map_wavelength([450.0, 550.0, 650.0])
    assert rgb[0, 2] > rgb[0, 0] and rgb[1, 1] > rgb[1, 2] \
        and rgb[2, 0] > rgb[2, 2]


def test_map_to_color_matches_jax():
    pytest.importorskip('matplotlib')
    a = np.linspace(-1.0, 3.0, 33)
    w = np.linspace(0.0, 1.2, 33)
    for kw in ({}, dict(range=(0.0, 2.0)), dict(weights=w),
               dict(map_name='viridis')):
        got = color.map_to_color(a, **kw)
        assert got.dtype == np.uint32
        assert _same(got, jcolor.map_to_color(a, **kw)), kw


def test_tools_match_jax(tmp_path, capsys):
    a = np.array([[0, 1, 2], [0, 0, 3]])
    assert tools.count_nonzero(a) == jtools.count_nonzero(a) == 3
    assert _same(tools.filled_array(7, (2, 3), np.int16),
                 jtools.filled_array(7, (2, 3), np.int16))

    timed = tools.timeit(lambda x: x + 1)
    assert timed(1) == 2
    out = capsys.readouterr().out
    assert out.endswith(' elapsed in <lambda>().\n')
    float(out.split()[0])

    def f(x):
        return x
    assert tools.profile_if_possible(f) is f
    assert jtools.profile_if_possible(f) is f

    calls = []

    @tools.memoize
    def square(x):
        calls.append(x)
        return x * x
    assert [square(3), square(3), square(4)] == [9, 9, 16]
    assert calls == [3, 4] and square.__name__ == 'square'

    path = tmp_path / 'profile.csv'
    path.write_text('# r, y\n1.0, 2.0\n\n-3.5 4.25  # a comment\n'
                    '5e-1,\t6\n')
    got = tools.read_csv(str(path))
    assert _same(got, jtools.read_csv(str(path)))
    assert _same(got, np.array([[1.0, 2.0], [-3.5, 4.25], [0.5, 6.0]]))

    from chroma_tpu.likelihood import UFloat as JUFloat
    from chroma_tpu_torch.likelihood import UFloat
    for value, err in ((12.3456, 0.0789), (-1.5, 0.25), (1234.5, 56.0)):
        s = tools.ufloat_to_str(UFloat(value, err))
        assert s == jtools.ufloat_to_str(JUFloat(value, err))
    assert tools.ufloat_to_str(UFloat(12.3456, 0.0789)) == '12.35 +/- 0.08'

    hook = sys.excepthook
    try:
        tools.enable_debug_on_crash()
        assert sys.excepthook is not hook
        # not a terminal here: the hook hands over to the default one
        try:
            raise KeyError('k')
        except KeyError:
            sys.excepthook(*sys.exc_info())
        assert 'KeyError' in capsys.readouterr().err
    finally:
        sys.excepthook = hook


def _profile_csv(path, profile):
    """A two-column profile file with both halves (x < 0 mirrored), as
    ``build_pmt`` reads them, with a comment and comma separators."""
    rows = np.concatenate([profile * [-1.0, 1.0], profile[::-1]])
    with open(path, 'w') as f:
        f.write('# x, y (mm)\n')
        for x, y in rows:
            f.write('%r, %r\n' % (float(x), float(y)))


def _same_solid(a, b):
    return (_same(a.mesh.vertices, b.mesh.vertices)
            and _same(a.mesh.triangles, b.mesh.triangles)
            and _same(a.color, b.color)
            and [getattr(s, 'name', s) for s in a.surface]
            == [getattr(s, 'name', s) for s in b.surface])


def test_pmt_builders_match_jax(tmp_path):
    """build_pmt, build_pmt_shell from a profile file, and
    build_light_collector on the demo PMT and from a file: vertices,
    triangles, colours and surfaces equal to the JAX builders'."""
    from chroma_tpu.demo import optics as joptics
    from chroma_tpu.demo import pmt as jdemo_pmt
    from chroma_tpu_torch.demo import optics
    from chroma_tpu_torch.demo import pmt as demo_pmt
    path = str(tmp_path / 'pmt.csv')
    _profile_csv(path, demo_pmt.pmt_profile())
    lc_path = str(tmp_path / 'lc.csv')
    with open(lc_path, 'w') as f:
        f.write('# r y\n')
        for r, y in demo_pmt.lc_profile():
            f.write('%r %r\n' % (float(r), float(y)))

    def build(p, o, demo):
        yield p.build_pmt(path, 3.0, o.water, o.glass, o.vacuum,
                          o.r7081hqe_photocathode, o.shiny_surface,
                          nsteps=12)
        yield p.build_pmt_shell(path, o.water, o.glass, nsteps=12)
        yield p.build_light_collector(demo.build_8inch_pmt(nsteps=12),
                                      30.0, 60.0, 140.0, 126.5, 161.0,
                                      o.shiny_surface)
        yield p.build_light_collector_from_file(lc_path, o.water,
                                                o.shiny_surface, nsteps=16)

    got = list(build(pmt, optics, demo_pmt))
    want = list(build(jpmt, joptics, jdemo_pmt))
    for g, w in zip(got, want):
        assert len(g.mesh.triangles) > 0
        assert np.isfinite(g.mesh.vertices).all()
        assert _same_solid(g, w)
    assert _same(got[0].profile, want[0].profile)
    radii = np.linspace(126.5, 161.0, 7)
    lc = (30.0, 60.0, 140.0, 126.5, 161.0)
    assert _same(pmt.get_lc_profile(radii, *lc),
                 jpmt.get_lc_profile(radii, *lc))
    with pytest.raises(Exception, match='must be an instance'):
        pmt.build_light_collector(object(), 1, 1, 1, 1, 2, None)


def test_run_referee_passes_on_demo_tiny():
    """Both checks at widths 256 and 512 on CPU tensors (check 2 is the
    plain walker against itself here: no kernel on the CPU)."""
    det = host.demo.tiny()
    det.flatten()
    tables = gpu.GPUGeometry(det, 'cpu').geom
    assert referee.run_referee(tables, widths=(256, 512),
                               verbose=False) == []
    assert referee.WIDTHS == jreferee.WIDTHS


def test_diff_keys_flags_a_flipped_bit():
    a = {'flags': np.arange(8, dtype=np.uint32),
         'pos': torch.ones((8, 3), dtype=torch.float32)}
    b = {k: v.copy() if isinstance(v, np.ndarray) else v.clone()
         for k, v in a.items()}
    assert referee._diff_keys(a, b) == []
    b['flags'][3] ^= np.uint32(1 << 31)
    bad = referee._diff_keys(a, b)
    assert bad == ['flags (1 words differ)']
    b['pos'][2, 1] = -1.0
    assert len(referee._diff_keys(a, b)) == 2


def test_live_state_matches_jax():
    got = referee.live_state(64)
    want = jreferee._live_state(64)
    for k, v in want.items():
        w = np.asarray(v)
        g = got[k]
        if w.dtype == np.uint32:
            g = g.view(np.uint32) if g.dtype == np.int32 else \
                g.astype(np.uint32)
        assert _same(g, w), k


def test_cuda_context_and_rng_stream():
    ctx = gpu.create_cuda_context()
    assert ctx.pop() is None
    assert 'create_cuda_context' in gpu.__all__
    a = gpu.RNGStream(3, 'cpu')
    b = gpu.RNGStream(3, 'cpu')
    seeds = [a.next() for _ in range(3)]
    assert seeds == [b.next() for _ in range(3)]
    assert len(set(seeds)) == 3
    assert all(0 <= s < 2 ** 63 for s in seeds)


def test_top_level_names():
    from chroma_tpu_torch import (detector, event, geometry, loader, make,
                                  stl)
    assert chroma_tpu_torch.__all__ == chroma_tpu.__all__
    home = dict(event=event, Photons=event, Vertex=event, Event=event,
                Channels=event, Mesh=geometry, Solid=geometry,
                Material=geometry, Surface=geometry,
                DichroicProps=geometry, Geometry=geometry, vacuum=geometry,
                standard_wavelengths=geometry, Detector=detector, make=make,
                mesh_from_stl=stl,
                load_geometry_from_string=loader,
                create_geometry_from_obj=loader)
    assert set(home) == set(chroma_tpu_torch.__all__)
    for name, module in home.items():
        got = getattr(chroma_tpu_torch, name)
        want = module if name in ('event', 'make') \
            else getattr(module, name)
        assert got is want, name
    assert chroma_tpu_torch.Photons is chroma_tpu_torch.event.Photons
