"""The host side of the step physics kernel, on the CPU.

csrc/physics_step.cu runs only on the card, where tests/test_torch_cuda.py
holds it to ``physics_update_plain`` bit for bit.  Here:

* ``kernel_serves`` picks the plain path for CPU tensors and for tables
  with a WLS, dichroic or thin-film surface, and the kernel for the
  other tables on a CUDA device;
* ``physics_update`` dispatches on it: where it serves, the kernel's
  result (a stand-in here) and the counter ``step.physics_kernel_photons``
  adds the call's photons; otherwise the plain version runs and nothing
  is counted;
* ``physics_update_cuda`` raises on a wrong dtype or shape and on a CPU
  tensor, before it builds or launches anything;
* its pointer slots are as many as csrc/physics_step.cu's enum Slot, in
  the same groups.
"""
import dataclasses
import os
import re

import pytest
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu_torch import _build, host, tracing
from chroma_tpu_torch.ops import propagate
from chroma_tpu_torch.ops.geometry_pack import pack_geometry
from tests import torch_scenes

CPU = torch.device('cpu')
CUDA = torch.device('cuda')


@pytest.fixture(scope='module')
def water():
    return pack_geometry(torch_scenes.water_scene(), CPU)


@pytest.mark.parametrize('gate,serves', [
    ('reemission', True), ('wls', False), ('dichroic', False),
    ('complex', False)])
def test_kernel_serves_the_gate_boxes(gate, serves):
    tables = pack_geometry(host.gate_box(gate), CPU)
    assert propagate.kernel_serves(tables, CUDA) is serves
    assert propagate.kernel_serves(tables, CPU) is False


@pytest.mark.parametrize('flag', ['has_wls', 'has_dichroic', 'has_complex'])
def test_kernel_serves_no_table_with_a_plain_only_model(water, flag):
    assert propagate.kernel_serves(water, CUDA)
    assert not propagate.kernel_serves(water, CPU)
    assert not propagate.kernel_serves(
        dataclasses.replace(water, **{flag: True}), CUDA)


def _assert_bits_equal(got, want):
    for key, v in want.items():
        a, b = got[key], v
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), key


def _no_build(monkeypatch):
    def refuse():
        raise AssertionError('the kernel library was asked for')
    monkeypatch.setattr(_build, 'library', refuse)


def test_dispatch_takes_the_kernel_where_it_serves(water, monkeypatch):
    _no_build(monkeypatch)
    args = torch_scenes.physics_inputs(water, 500, 1, CPU)
    calls = []

    def stand_in(*a):
        calls.append(a)
        return 'kernel'
    monkeypatch.setattr(propagate, 'physics_update_cuda', stand_in)
    monkeypatch.setattr(propagate, 'kernel_serves', lambda t, d: True)
    with tracing.recording() as rec:
        assert propagate.physics_update(*args, -1, use_weights=True) \
            == 'kernel'
    assert len(calls) == 1 and calls[0][-2:] == (-1, True)
    assert rec.counts == {'step.physics_kernel_photons': 500}


def test_dispatch_on_the_cpu_is_the_plain_version(water, monkeypatch):
    _no_build(monkeypatch)
    args = torch_scenes.physics_inputs(water, 500, 2, CPU)
    with tracing.recording() as rec:
        got = propagate.physics_update(*args, 1)
    _assert_bits_equal(got, propagate.physics_update_plain(*args, 1))
    assert rec.counts == {}


def test_wrapper_refuses_before_building(water, monkeypatch):
    _no_build(monkeypatch)
    state, res, _, u, flags, active, nan_mask = \
        torch_scenes.physics_inputs(water, 64, 3, CPU)
    with pytest.raises(ValueError, match='state pos must be a CUDA tensor'):
        propagate.physics_update_cuda(state, res, water, u, flags, active,
                                      nan_mask)
    bad = dict(state, pos=state['pos'].double())
    with pytest.raises(ValueError, match='state pos must be torch.float32'):
        propagate.physics_update_cuda(bad, res, water, u, flags, active,
                                      nan_mask)
    with pytest.raises(ValueError, match=r'arg u must be .*\(64, 20\)'):
        propagate.physics_update_cuda(state, res, water, u[:, :19], flags,
                                      active, nan_mask)
    short = dict(res, normal=res['normal'][:63])
    with pytest.raises(ValueError, match='res normal'):
        propagate.physics_update_cuda(state, short, water, u, flags, active,
                                      nan_mask)
    with pytest.raises(ValueError, match='WLS'):
        propagate.physics_update_cuda(
            state, res, dataclasses.replace(water, has_wls=True), u, flags,
            active, nan_mask)


def test_slots_match_the_kernel():
    path = os.path.join(_build.CSRC_DIR, 'physics_step.cu')
    with open(path) as f:
        body = re.search(r'enum Slot \{(.*?)\};', f.read(), re.S).group(1)
    names = [w.strip() for w in body.split(',') if w.strip()]
    assert names[-1] == 'NSLOTS'
    nphoton = len(propagate._PHOTON_SLOTS)
    ntable = len(propagate._TABLE_SLOTS)
    assert names.index('S_SF') == nphoton
    assert names.index('S_POS_OUT') == nphoton + 1 + ntable
    assert len(names) - 1 == nphoton + 1 + ntable \
        + len(propagate._OUT_SLOTS)
    assert [key for _, key, _, _ in propagate._OUT_SLOTS] == [
        'pos', 'dir', 'pol', 'wavelength', 't', 'weight', 'flags',
        'last_hit_triangle']
