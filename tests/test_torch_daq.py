"""chroma_tpu_torch run_daq against the JAX package's, bit for bit.

Both get the same photon state (made with numpy from a seed) and the
same (3, ndaq, n) draw block (JAX's own ``jax.random.uniform`` draws).
Minima, integer charge sums and OR-ed history bits do not depend on the
scatter order, so times, charges and flags must be equal exactly.
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp
import torch

from chroma_tpu import demo, event
from chroma_tpu.ops import geometry_pack as jgp
from chroma_tpu.ops import daq as jdaq
from chroma_tpu_torch.ops import daq as tdaq
from tests.test_torch_tables import port_tables


@pytest.fixture(scope='module')
def tiny_tables():
    det = demo.tiny()
    det.flatten()
    jgeom, jdet = jgp.pack_detector(det)
    return jgeom, jdet, port_tables(jgeom, jdet)


def _photon_state(n, ntri, nevents, seed):
    """A propagated-looking batch: random last-hit triangles (some -1),
    history words with random process bits (some detected, some
    NaN-aborted), weights, times and event indices (some out of range,
    as batch padding carries)."""
    rng = np.random.RandomState(seed)
    tri = rng.randint(-1, ntri, size=n).astype(np.int32)
    tri[rng.rand(n) < 0.1] = -1
    flags = rng.randint(0, 1 << 12, size=n).astype(np.uint32)
    flags |= np.where(rng.rand(n) < 0.6, event.SURFACE_DETECT,
                      0).astype(np.uint32)
    flags |= np.where(rng.rand(n) < 0.05, event.NAN_ABORT,
                      0).astype(np.uint32)
    evidx = rng.randint(0, nevents, size=n).astype(np.uint32)
    evidx[rng.rand(n) < 0.05] = 0xFFFFFFFF
    return dict(
        pos=rng.normal(size=(n, 3)).astype(np.float32),
        t=rng.uniform(0.0, 50.0, size=n).astype(np.float32),
        weight=rng.uniform(0.0, 1.2, size=n).astype(np.float32),
        flags=flags, last_hit_triangle=tri, evidx=evidx)


def _to_port(state):
    out = {}
    for k, v in state.items():
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        out[k] = torch.from_numpy(v.copy())
    return out


@pytest.mark.parametrize('ndaq,nevents,global_weight', [
    (1, 1, 1.0), (2, 3, 1.0), (2, 3, 0.7)])
def test_run_daq_bit_exact(tiny_tables, ndaq, nevents, global_weight):
    jgeom, jdet, (pgeom, pdet) = tiny_tables
    n = 4096
    state = _photon_state(n, int(jgeom.solid_id_map.shape[0]), nevents,
                          seed=ndaq * 10 + nevents)
    key = jax.random.PRNGKey(ndaq + 7 * nevents)
    u = np.asarray(jax.random.uniform(key, (3, ndaq, n),
                                      dtype=jnp.float32))
    ref = jdaq.run_daq({k: jnp.asarray(v) for k, v in state.items()},
                       jgeom, jdet, key, jdet.nchannels, ndaq=ndaq,
                       nevents=nevents, global_weight=global_weight)
    out = tdaq.run_daq(_to_port(state), pgeom, pdet,
                       torch.from_numpy(u.copy()),
                       pdet.nchannels, ndaq=ndaq, nevents=nevents,
                       global_weight=global_weight)
    t_ref = np.asarray(ref['t'])
    assert (t_ref < 1e8).sum() > 50          # the case digitizes hits
    assert np.array_equal(out['t'].numpy(), t_ref)
    assert np.array_equal(out['q'].numpy(), np.asarray(ref['q']))
    assert np.array_equal(out['flags'].numpy().view(np.uint32),
                          np.asarray(ref['flags']))


def test_gpu_daq_accumulates(tiny_tables):
    """GPUDaq: acquisitions combine by min time, summed charge and OR-ed
    flags; an empty acquisition reads no hits."""
    _, _, (pgeom, pdet) = tiny_tables

    class Det:
        geom, det = pgeom, pdet

    state = _to_port(_photon_state(2048, int(pgeom.solid_id_map.shape[0]),
                                   1, seed=3))
    daq = tdaq.GPUDaq(Det())
    daq.begin_acquire()
    assert not daq.end_acquire().get().hit.any()
    g = torch.Generator().manual_seed(0)
    daq.begin_acquire()
    first = {k: v.clone() for k, v in daq.acquire(state, g).items()}
    both = daq.acquire(state, g)
    assert torch.all(both['t'] <= first['t'])
    assert torch.all(both['q'] >= first['q'])
    assert torch.equal(both['flags'] & first['flags'], first['flags'])
    ch = daq.end_acquire().get()
    assert ch.hit.sum() == int((both['t'] < 1e8).sum())
    assert ch.flags.dtype == np.uint32
