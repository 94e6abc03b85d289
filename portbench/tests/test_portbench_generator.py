"""The muon bank against its formulas, the generator finding a source
kind by its name, and the order calls draw a bank in."""

import numpy as np
import pytest
import torch

from portbench import generator
from portbench.sources import muon_chord

SOURCE = dict(kind='muon_chord', bank_events=4, beta=1.0,
              refractive_index=1.33, wavelength_nm=[400.0, 420.0])
RADIUS = 1850.0
CFG = dict(fiducial_radius_mm=RADIUS)
SEED = 2 ** 31 + 12345


@pytest.fixture(scope='module')
def bank():
    return generator.make_bank(SOURCE, CFG, SEED, torch.device('cpu'))


def _events(bank):
    off = bank['offsets']
    for k in range(len(off) - 1):
        yield k, slice(off[k], off[k + 1])


def test_frank_tamm_yield():
    # 2 pi alpha (1 - 1/n^2) (1/300 nm - 1/600 nm) = 332 photons/cm
    per_cm = muon_chord.frank_tamm_per_mm(1.0, 1.33, 300.0, 600.0) * 10
    assert abs(per_cm - 332.2) < 0.1


def test_photon_count_per_chord(bank):
    L, b = muon_chord.chord_lengths(RADIUS, SOURCE['bank_events'])
    per_mm = muon_chord.frank_tamm_per_mm(1.0, 1.33, 400.0, 420.0)
    assert (np.diff(bank['offsets']) == np.rint(per_mm * L)).all()
    assert np.allclose(bank['meta']['length'], L)
    assert np.allclose(L ** 2 / 4 + b ** 2, RADIUS ** 2)


def test_cone_angle_and_polarization(bank):
    for k, sl in _events(bank):
        d = bank['meta']['direction'][k]
        u = bank['dir'][sl].astype(np.float64)
        pol = bank['pol'][sl].astype(np.float64)
        assert np.allclose(u @ d, 1 / 1.33, atol=2e-6)
        assert np.allclose((u * pol).sum(1), 0, atol=2e-6)
        # in the plane of track and photon
        assert np.allclose((np.cross(u, pol) * d).sum(1) ** 2
                           + (u @ d) ** 2 + (pol @ d) ** 2, 1, atol=1e-5)


def test_photons_start_on_the_chord(bank):
    c = 299.792458
    for k, sl in _events(bank):
        e = bank['meta']['entry'][k]
        d = bank['meta']['direction'][k]
        rel = bank['pos'][sl].astype(np.float64) - e
        s = rel @ d
        assert np.abs(rel - s[:, None] * d).max() < 1e-3
        assert s.min() >= -1e-3 and s.max() <= bank['meta']['length'][k] + 1e-3
        assert np.allclose(bank['t'][sl], s / c, atol=1e-5)
        assert np.linalg.norm(bank['pos'][sl], axis=1).max() < RADIUS + 1e-2


def test_spectrum_is_one_over_lambda_squared(bank):
    lam1, lam2 = SOURCE['wavelength_nm']
    for k, sl in _events(bank):
        w = np.sort(bank['wavelengths'][sl].astype(np.float64))
        n = len(w)
        cdf = (1 / lam1 - 1 / w) / (1 / lam1 - 1 / lam2)
        assert np.abs(cdf - (np.arange(n) + 0.5) / n).max() < 1e-4
        assert (np.diff(w) > 0).all()          # distinct float32 values


def test_zenith_is_downward(bank):
    assert (bank['meta']['direction'][:, 2] < 0).all()


def test_same_seed_same_bank_and_same_sizes_for_any_seed(bank):
    again = generator.make_bank(SOURCE, CFG, SEED, torch.device('cpu'))
    other = generator.make_bank(SOURCE, CFG, SEED + 1,
                                torch.device('cpu'))
    for f in ('pos', 'dir', 'pol', 'wavelengths', 't'):
        assert np.array_equal(bank[f], again[f])
    assert np.array_equal(bank['offsets'], other['offsets'])
    assert not np.array_equal(bank['dir'], other['dir'])


def test_the_kind_is_found_by_name(bank):
    direct = muon_chord.make_bank(SOURCE, CFG, SEED, torch.device('cpu'))
    assert np.array_equal(direct['pos'], bank['pos'])
    with pytest.raises(KeyError):
        generator.make_bank(dict(SOURCE, kind='no_such_kind'), CFG, SEED,
                            torch.device('cpu'))


def test_event_order():
    counts = np.array([5, 7, 9, 11])
    a = generator.EventOrder(counts, 20, 7)
    b = generator.EventOrder(counts, 20, 7)
    for _ in range(10):
        ids, n = a.next_call()
        assert (ids, n) == b.next_call()
        assert n == counts[ids].sum() >= 20
        assert n - counts[ids[-1]] < 20
        assert len(set(ids)) == len(ids)


def test_stream_seeds_take_large_seeds():
    s = generator.stream_seeds(2 ** 33 + 5)
    assert len(set(s.values())) == 4
    assert all(0 <= v < 2 ** 62 for v in s.values())
    assert s == generator.stream_seeds(2 ** 33 + 5)
