"""The four gated physics models and weighted propagation of
chroma_tpu_torch against the JAX package.

Each gate (bulk reemission, WLS, dichroic and thin-film "complex"
surfaces) has a small scene, ``host.gate_box`` (murky variant, so bulk
scattering and absorption compete with the surfaces; the thin film
detects with efficiency 0.2).  Each package builds it with its own host
modules, and the packed tables must be bit-equal before physics is
compared.

One ``physics_update`` from the same photon state (a numpy-seeded bomb,
every eighth photon's weight below WEIGHT_LOWER_THRESHOLD), the same
traversal result and the same draw block (JAX's own
``jax.random.uniform(key, (n, 20))``), per gate x ``use_weights`` x
``scatter_first`` at step 0, and per gate x ``use_weights`` after one
JAX step (photons then sit on the inner cube, in the gap and on the
counter wall).  Bounds, as tests/test_torch_propagate.py states them:
flags, last_hit_triangle, evidx and index equal for every photon; floats
within 1e-4 relative to the vector's largest component (that file's
one-step bound; measured here over all 32 cases: 6.3e-7).

``thin_film_rta`` on the 180 cases of
tests/test_propagation.py::test_thin_film_transfer_matrix: within 5e-6
(absolute, on probabilities in [0, 1]; measured 1.2e-6) of the JAX
function, and within 2e-3 absolute and relative (that test's bound) of a
complex128 solution of the three-layer boundary-value problem, which
fixes the branch of the complex square roots in an absorbing film and
past the exit layer's critical angle.

One ``_service_ondeck`` pass with ``use_weights=True`` and forbidden
first scattering, against the JAX one from the same lane state, with
tests/test_torch_fused.py's bounds.

``referee.gate_box_checks`` on the CPU, 20,000 photons a run through the
on-deck driver: each model's one-step outcome shares against the
probabilities its scene specifies, and the weighted detection sum against
the unweighted count, within 5 sigma (the check chip_smoke.py makes on a
card with 200,000).
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

from chroma_tpu import event, geometry as jgeometry, make as jmake
from chroma_tpu.generator.photon import photon_bomb
from chroma_tpu.ops import geometry_pack as jgp
from chroma_tpu.ops import mbvh as jmbvh
from chroma_tpu.ops import photon as jphoton
from chroma_tpu.ops import propagate as jprop
from chroma_tpu_torch import host, referee
from chroma_tpu_torch.ops import geometry_pack as tgp
from chroma_tpu_torch.ops import propagate as tprop
from tests.test_torch_fused import (assert_service_pass_matches,  # noqa: F401
                                    run_service_pass, tiny)
from tests.test_torch_propagate import N, STEP_RTOL, _compare, _to_port
from tests.test_torch_tables import _assert_equal_tables

FILM_QE = 0.2
RTA_ATOL = 5e-6
# the flag only this gate's model sets, seen when photons reach it
SIGNATURE = dict(reemission=event.BULK_REEMIT, wls=event.SURFACE_REEMIT,
                 dichroic=event.SURFACE_TRANSMIT,
                 complex=event.SURFACE_DETECT)


@pytest.fixture(scope='module', params=host.GATES)
def gate(request):
    """(name, JAX tables, port tables, uploaded JAX photon state)."""
    name = request.param
    jgeom = jgp.pack_geometry(host.gate_box(
        name, murky=True, film_detect=FILM_QE, geometry=jgeometry,
        make=jmake))
    pgeom = tgp.pack_geometry(host.gate_box(name, murky=True,
                                            film_detect=FILM_QE), 'cpu')
    np.random.seed(31)
    photons = photon_bomb(N, 400.0, (3.0, -2.0, 1.0)).photons_beg
    photons.weights[::8] = 0.5 * tprop.WEIGHT_LOWER_THRESHOLD
    return name, jgeom, pgeom, jphoton.upload_photons(photons)


def test_gate_box_packs_like_jax(gate):
    """Each package builds the gate box with its own host modules; the
    packed tables, the gate's own among them, are bit-equal and only
    this gate is on."""
    name, jgeom, pgeom, _ = gate
    _assert_equal_tables(jgeom, pgeom)
    on = dict(reemission=pgeom.has_reemission, wls=pgeom.has_wls,
              dichroic=pgeom.has_dichroic, complex=pgeom.has_complex)
    assert [k for k, v in on.items() if v] == [name]
    assert pgeom.has_surfaces


def _one_update(gate, use_weights, scatter_first, steps_before):
    name, jgeom, pgeom, state = gate
    key = jax.random.PRNGKey(17 + steps_before)
    for _ in range(steps_before):
        key, sk = jax.random.split(key)
        state = jprop.propagate_step(state, jgeom, sk, 0,
                                     use_weights=use_weights)
    u = jax.random.uniform(key, (N, jprop.NDRAWS), dtype=jnp.float32)
    flags = state['flags']
    alive = (flags & jnp.uint32(event.TERMINAL_FLAGS)) == 0
    res = jmbvh.intersect_mesh(state['pos'], state['dir'], jgeom,
                               state['last_hit_triangle'], active=alive)
    ref = jprop.physics_update(state, res, jgeom, u, flags, alive,
                               jnp.zeros(N, bool), scatter_first,
                               use_weights=use_weights)
    ts = _to_port(state)
    out = tprop.physics_update(
        ts, _to_port(res), pgeom, torch.from_numpy(np.array(u)),
        ts['flags'], torch.from_numpy(np.array(alive)),
        torch.zeros(N, dtype=torch.bool), scatter_first,
        use_weights=use_weights)
    same, err = _compare(ref, out)
    assert same.all()
    assert err <= STEP_RTOL
    return np.asarray(ref['flags']), int(alive.sum()), out


@pytest.mark.parametrize('scatter_first', [0, 1, -1])
@pytest.mark.parametrize('use_weights', [False, True])
def test_gate_physics_update_matches_jax(gate, use_weights, scatter_first):
    flags, nalive, out = _one_update(gate, use_weights, scatter_first, 0)
    assert nalive == N
    if scatter_first == 1:
        # forced: a photon scatters before it reaches a surface, unless
        # (unweighted) it is absorbed first
        assert ((flags & event.RAYLEIGH_SCATTER) != 0).mean() > 0.8
    elif not use_weights or gate[0] in ('dichroic', 'complex'):
        assert ((flags & SIGNATURE[gate[0]]) != 0).sum() >= 10
    if use_weights:
        w = out['weight'].numpy()
        assert ((flags & event.BULK_ABSORB) != 0).sum() \
            <= (w < tprop.WEIGHT_LOWER_THRESHOLD).sum()
        assert (w < 1.0).mean() > 0.9


@pytest.mark.parametrize('use_weights', [False, True])
def test_gate_second_step_matches_jax(gate, use_weights):
    """After one JAX step the photons are spread over the scene, some on
    the counter wall, where weighted propagation forces detection."""
    flags, nalive, _ = _one_update(gate, use_weights, 0, 1)
    assert 50 < nalive < N
    assert ((flags & event.SURFACE_DETECT) != 0).sum() \
        >= (5 if use_weights else 1)


def _bvp_rt(n1, n2, n3, cos1, wl_nm, d_nm):
    """(Rs, Ts, Rp, Tp) of a film between two half-spaces from first
    principles in complex128: plane waves matched at both interfaces."""
    n1, n2, n3 = complex(n1), complex(n2), complex(n3)
    k0 = 2.0 * np.pi / wl_nm
    kx = k0 * (n1 * np.sqrt(1.0 - cos1 ** 2)).real
    kz = []
    for n in (n1, n2, n3):
        kzj = np.sqrt((k0 * n) ** 2 - kx ** 2 + 0j)
        kz.append(-kzj if kzj.imag < 0 else kzj)     # the decaying branch
    k1, k2z, k3 = kz
    out = []
    for pol in ('s', 'p'):
        w = (1.0, 1.0, 1.0) if pol == 's' else \
            (1.0 / n1 ** 2, 1.0 / n2 ** 2, 1.0 / n3 ** 2)
        ph = np.exp(1j * k2z * d_nm)
        M = np.array([
            [-1.0, 1.0, 1.0, 0.0],
            [w[0] * k1, w[1] * k2z, -w[1] * k2z, 0.0],
            [0.0, ph, 1.0 / ph, -1.0],
            [0.0, w[1] * k2z * ph, -w[1] * k2z / ph, -w[2] * k3],
        ], dtype=np.complex128)
        b = np.array([1.0, w[0] * k1, 0.0, 0.0], np.complex128)
        r, _, _, t = np.linalg.solve(M, b)
        out.extend([abs(r) ** 2,
                    (w[2] * k3).real / (w[0] * k1).real * abs(t) ** 2])
    return out


def test_thin_film_rta_matches_jax_and_transfer_matrix():
    cases = [(n1, n2, n3, cos1, wl, d_nm)
             for n1, n2, n3 in [(1.33, 2.7 + 1.5j, 1.49),
                                (1.0, 1.5 + 0.1j, 1.33),
                                (1.49, 3.5 + 0.5j, 1.0),    # exit TIR region
                                (1.33, 1.9 + 0.0j, 1.33)]   # lossless film
             for cos1 in (1.0, 0.9, 0.6, 0.3, 0.1)
             for wl in (300.0, 400.0, 600.0)
             for d_nm in (10.0, 30.0, 120.0)]
    cols = [np.array(c, np.float32) for c in (
        [c[0] for c in cases], [c[1].real for c in cases],
        [c[1].imag for c in cases], [c[2] for c in cases],
        [c[3] for c in cases], [c[4] for c in cases],
        [c[5] * 1e-6 for c in cases])]                      # nm -> mm
    ref = [np.asarray(a) for a in jprop.thin_film_rta(
        *[jnp.asarray(c) for c in cols])]
    out = [a.numpy() for a in tprop.thin_film_rta(
        *[torch.from_numpy(c) for c in cols])]
    for a, b in zip(ref, out):
        assert b.dtype == np.float32
        assert np.abs(a - b).max() <= RTA_ATOL
    want = np.array([_bvp_rt(*c) for c in cases])
    np.testing.assert_allclose(np.stack(out[:4], axis=1), want, atol=2e-3,
                               rtol=2e-3)


def test_service_pass_with_weights_matches_jax(tiny):
    sp = run_service_pass(tiny, 1, use_weights=True, scatter_first=-1)
    assert_service_pass_matches(sp)
    weight = sp['pool'][:sp['n'], 11].view(torch.float32)
    assert (weight < 1.0).sum() > 50


@pytest.mark.parametrize('name', host.GATES)
def test_gate_box_checks_on_cpu(name):
    results = referee.gate_box_checks(name, 'cpu', n=20000, seed=40)
    assert len(results) >= 4
    for what, observed, expected, sigma in results:
        assert abs(observed - expected) <= 5.0 * sigma, \
            (what, observed, expected, sigma)
