"""chroma_tpu_torch physics and step driver against the JAX package.

Same tables, same photons (a numpy-seeded bomb in demo.tiny), same
traversal result and the same draw blocks (JAX's own
``jax.random.uniform(key, (n, 20))``), so the two packages take the same
branches.  Floats are not bit-equal: XLA contracts a*b+c into fused
multiply-adds, and torch and XLA implement log, exp, arccos, sin and tan
differently.

Bounds (measured on these cases, then about 3x of room):
* one step: flags, last_hit_triangle, evidx and index equal for every
  photon; floats within 1e-4 relative (measured 3.6e-6, and 3.4e-5 with
  forced first scattering, whose log1p differs most);
* ten steps of the driver: integer fields equal for >= 99% of photons
  (measured 100%: a flipped branch, such as u_reflect < r*r at a few ulp,
  is possible but rare), and on those photons floats within 5e-5
  relative (measured 4.9e-6).
Vector fields are compared relative to the vector's largest component.
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp
import torch

from chroma_tpu import demo, event
from chroma_tpu.generator.photon import photon_bomb
from chroma_tpu.ops import geometry_pack as jgp
from chroma_tpu.ops import mbvh as jmbvh
from chroma_tpu.ops import photon as jphoton
from chroma_tpu.ops import propagate as jprop
from chroma_tpu_torch.ops import photon as tphoton
from chroma_tpu_torch.ops import propagate as tprop
from tests.test_torch_tables import port_tables

N = 512
STEP_RTOL = 1e-4
DRIVER_RTOL = 5e-5
INT_FIELDS = ('flags', 'last_hit_triangle', 'evidx', 'index')


@pytest.fixture(scope='module')
def setup():
    det = demo.tiny()
    det.flatten()
    jgeom, jdet = jgp.pack_detector(det)
    pgeom, _ = port_tables(jgeom, jdet)
    np.random.seed(7)
    photons = photon_bomb(N, 400.0, (200.0, 0.0, 0.0)).photons_beg
    return jgeom, pgeom, jphoton.upload_photons(photons)


def _to_port(tree):
    out = {}
    for k, v in tree.items():
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(a.astype(np.int64) if k == 'index'
                                  else a.copy())
    return out


def _rel_err(a, b):
    if a.ndim == 2:
        return np.abs(a - b).max(axis=1) / np.maximum(
            np.abs(a).max(axis=1), 1e-30)
    return np.abs(a - b) / np.maximum(np.abs(a), 1e-30)


def _compare(jstate, tstate):
    """(photons whose integer fields all agree, max float rel error on
    them)."""
    same = np.ones(N, bool)
    for k in INT_FIELDS:
        a = np.asarray(jstate[k]).astype(np.int64)
        b = tstate[k].numpy()
        if k in ('flags', 'evidx'):
            b = b.view(np.uint32)
        same &= a == b.astype(np.int64)
    err = 0.0
    for k in ('pos', 'dir', 'pol', 'wavelength', 't', 'weight'):
        e = _rel_err(np.asarray(jstate[k]), tstate[k].numpy())[same]
        err = max(err, float(e.max()) if e.size else 0.0)
    return same, err


def _states(setup, nsteps):
    """JAX states after 0..nsteps-1 JAX steps, with the key of each
    next step."""
    jgeom, _, state = setup
    key = jax.random.PRNGKey(3)
    out = []
    for _ in range(nsteps):
        key, sk = jax.random.split(key)
        out.append((state, sk))
        state = jprop.propagate_step(state, jgeom, sk, 0)
    return out


@pytest.mark.parametrize('step', [0, 1, 2])
def test_physics_update_matches_jax(setup, step):
    jgeom, pgeom, _ = setup
    state, key = _states(setup, step + 1)[step]
    u = jax.random.uniform(key, (N, jprop.NDRAWS), dtype=jnp.float32)
    flags = state['flags']
    alive = (flags & jnp.uint32(event.TERMINAL_FLAGS)) == 0
    res = jmbvh.intersect_mesh(state['pos'], state['dir'], jgeom,
                               state['last_hit_triangle'], active=alive)
    ref = jprop.physics_update(state, res, jgeom, u, flags, alive,
                               jnp.zeros(N, bool), 0)
    ts = _to_port(state)
    out = tprop.physics_update(
        ts, _to_port(res), pgeom, torch.from_numpy(np.array(u)),
        ts['flags'], torch.from_numpy(np.array(alive)),
        torch.zeros(N, dtype=torch.bool), 0)
    same, err = _compare(ref, out)
    assert same.all()
    assert err <= STEP_RTOL


@pytest.mark.parametrize('scatter_first', [0, 1, -1])
def test_propagate_step_matches_jax(setup, scatter_first):
    jgeom, pgeom, state = setup
    key = jax.random.PRNGKey(5)
    u = jax.random.uniform(key, (N, jprop.NDRAWS), dtype=jnp.float32)
    ref = jprop.propagate_step(state, jgeom, key, scatter_first)
    out = tprop.propagate_step(_to_port(state), pgeom,
                               torch.from_numpy(np.array(u)), scatter_first)
    same, err = _compare(ref, out)
    assert same.all()
    assert err <= STEP_RTOL
    # the first step moves every photon to its first interaction
    assert (np.asarray(ref['t']) > 0).mean() > 0.99


def test_driver_ten_steps_matches_jax(setup):
    jgeom, pgeom, state = setup
    ref, ref_steps = jphoton.propagate(state, jgeom, jax.random.PRNGKey(11),
                                       max_steps=10)
    keys = [jax.random.PRNGKey(11)]

    def draws():
        # the same key chain as the JAX driver: split, then draw
        keys[0], sk = jax.random.split(keys[0])
        return torch.from_numpy(np.array(jax.random.uniform(
            sk, (N, tprop.NDRAWS), dtype=jnp.float32)))

    out, steps = tphoton.propagate(_to_port(state), pgeom, draws,
                                   max_steps=10)
    assert steps == int(ref_steps)
    same, err = _compare(ref, out)
    assert same.mean() >= 0.99
    assert err <= DRIVER_RTOL
    flags = out['flags'].numpy().view(np.uint32)
    assert ((flags & event.TERMINAL_FLAGS) != 0).mean() >= 0.99


def test_driver_pairs_draws_by_photon_index(setup):
    """Dropping dead photons from the working set leaves the pairing of
    photons and draw rows unchanged: a photon that died at step 0 in one
    batch does not shift anyone's draws."""
    _, pgeom, state = setup
    ts = _to_port(state)
    dead = ts['flags'].clone()
    dead[::2] |= event.NO_HIT                 # kill every other photon
    ts_dead = dict(ts, flags=dead)
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    a, _ = tphoton.propagate(ts, pgeom, tphoton.uniform_draws(g1, N),
                             max_steps=3)
    b, _ = tphoton.propagate(ts_dead, pgeom, tphoton.uniform_draws(g2, N),
                             max_steps=3)
    for k in ('pos', 'dir', 'flags', 't'):
        assert torch.equal(a[k][1::2], b[k][1::2]), k


@pytest.mark.parametrize('gate', ['has_reemission', 'has_wls',
                                  'has_dichroic', 'has_complex'])
def test_unported_physics_gates_raise(setup, gate):
    import dataclasses
    _, pgeom, state = setup
    tables = dataclasses.replace(pgeom, **{gate: True})
    ts = _to_port(state)
    with pytest.raises(NotImplementedError, match=gate):
        tprop.propagate_step(ts, tables, torch.rand(N, tprop.NDRAWS), 0)


def test_helpers_match_jax():
    """rotate, uniform_sphere, pick_new_direction and _sample_icdf_flat
    on the same inputs; unsort_photons inverts a permutation."""
    rng = np.random.RandomState(2)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    axis = rng.normal(size=(64, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    phi = rng.uniform(0, 6.28, size=64).astype(np.float32)
    u1, u2 = rng.uniform(size=(2, 64)).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (jprop.rotate(jnp.asarray(a), jnp.asarray(phi), jnp.asarray(axis)),
         tprop.rotate(t(a), t(phi), t(axis))),
        (jprop.uniform_sphere(jnp.asarray(u1), jnp.asarray(u2)),
         tprop.uniform_sphere(t(u1), t(u2))),
        (jprop.pick_new_direction(jnp.asarray(axis), jnp.asarray(u1),
                                  jnp.asarray(phi)),
         tprop.pick_new_direction(t(axis), t(u1), t(phi))),
    ]
    icdf = np.sort(rng.uniform(300, 600, size=(3, 2048)), axis=1) \
        .astype(np.float32)
    rows = rng.randint(0, 3, size=64).astype(np.int32)
    pairs.append((jprop._sample_icdf_flat(jnp.asarray(icdf),
                                          jnp.asarray(rows),
                                          jnp.asarray(u1)),
                  tprop._sample_icdf_flat(t(icdf), t(rows), t(u1))))
    for ref, out in pairs:
        assert _rel_err(np.asarray(ref), out.numpy()).max() <= STEP_RTOL
    state = tprop.make_photon_state(pos=a, dir=axis)
    perm = torch.from_numpy(rng.permutation(64))
    shuffled = {k: v[perm] for k, v in state.items()}
    back = tphoton.unsort_photons(shuffled)
    for k in state:
        assert torch.equal(back[k], state[k]), k
