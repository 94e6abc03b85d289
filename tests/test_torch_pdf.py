"""chroma_tpu_torch's PDF estimators against the JAX package's.

``GPUPDF`` and ``GPUKernelPDF`` of both packages are fed the same
synthetic channel readouts (numpy-seeded Gaussian hit times and charges,
as tests/test_pdf.py builds them, with a share of unhit channels at
t = 1e9 and some hits outside the window).  Bounds:

* every integer output is equal: the binned histogram and its hit counts
  (``get_pdfs``, uint32 in both), the variable-bin estimator's
  ``hitcount`` and the bin counts behind ``pdf_value``; ``nearest_mc``,
  the sorted distance table, is bit-equal (it holds differences of the
  same float32 values), 1D and 2D; so ``get_pdf_eval``'s values, computed
  on the host from those, agree to 1e-12 relative;
* the kernel (KDE) estimator: hit counts equal; bandwidths and pdf
  values within 1e-5 relative (measured 3.1e-7: exp and erf differ by an
  ulp or two between XLA and torch, and the moments are float32 sums).
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax.numpy as jnp
import torch

# one intra-op thread: the suite runs in several worker processes that
# share the cores, and oversubscribed thread teams stall each other
torch.set_num_threads(1)

from chroma_tpu.ops.pdf import GPUPDF as JGPUPDF, GPUKernelPDF as JGPUKernelPDF
from chroma_tpu_torch.ops.pdf import GPUPDF, GPUKernelPDF

TRANGE = (-50.0, 150.0)
QRANGE = (0.0, 10.0)
NCH = 64
KDE_RTOL = 1e-5


class Channels(object):
    """A channel readout as each package's ops/daq.py hands it over:
    flat (ndaq * nchannels,) time and charge arrays."""

    def __init__(self, t, q, ndaq, convert):
        self.t = convert(t)
        self.q = convert(q)
        self.ndaq = ndaq


def _batches(nbatches, ndaq, seed):
    """(t, q) pairs of shape (ndaq * NCH,): Gaussian times about a
    per-channel mean (some outside TRANGE), charges about 3 (some outside
    QRANGE), a fifth of the channels unhit (t = 1e9, q = 0)."""
    rng = np.random.RandomState(seed)
    mu = rng.uniform(0.0, 100.0, NCH)
    sigma = rng.uniform(3.0, 60.0, NCH)
    for _ in range(nbatches):
        t = rng.normal(mu, sigma, size=(ndaq, NCH)).astype(np.float32)
        q = rng.normal(3.0, 4.0, size=(ndaq, NCH)).astype(np.float32)
        unhit = rng.rand(ndaq, NCH) < 0.2
        t[unhit] = 1e9
        q[unhit] = 0.0
        yield t.ravel(), q.ravel()


def _event(seed):
    rng = np.random.RandomState(seed)
    hit = rng.rand(NCH) < 0.7
    t = rng.uniform(0.0, 100.0, NCH).astype(np.float32)
    q = rng.uniform(1.0, 5.0, NCH).astype(np.float32)
    return hit, t, q


def _feed(method_name, pdfs, batches, ndaq):
    for t, q in batches:
        for pdf, convert in zip(pdfs, (jnp.asarray, torch.from_numpy)):
            getattr(pdf, method_name)(Channels(t, q, ndaq, convert))


def test_binned_pdf_matches_jax():
    """``add_hits_to_pdf``: unhit channels (t = 1e9, beyond an int32 after
    scaling) and out-of-window hits are dropped alike; counts equal."""
    pdfs = JGPUPDF(), GPUPDF()
    for pdf in pdfs:
        pdf.setup_pdf(NCH, 20, TRANGE, 5, QRANGE)
    _feed('add_hits_to_pdf', pdfs, _batches(50, 1, 3), 1)
    (jhit, jpdf), (phit, ppdf) = (pdf.get_pdfs() for pdf in pdfs)
    for a, b in ((jhit, phit), (jpdf, ppdf)):
        assert a.dtype == b.dtype == np.uint32 and a.shape == b.shape
        assert np.array_equal(a, b)
    assert jpdf.sum() == jhit.sum() > 1000
    assert pdfs[1].events_in_histogram == 50
    pdfs[1].clear_pdf()
    assert not pdfs[1].get_pdfs()[1].any()


def test_binned_pdf_before_any_readout():
    pdf = GPUPDF()
    pdf.setup_pdf(NCH, 20, TRANGE, 5, QRANGE)
    hit, hist = pdf.get_pdfs()
    assert hit.dtype == hist.dtype == np.uint32
    assert hist.shape == (NCH, 20, 5) and not hist.any() and not hit.any()


@pytest.mark.parametrize('min_twidth,min_bin_content', [(1e-3, 12), (8.0, 6)])
@pytest.mark.parametrize('time_only', [True, False])
def test_pdf_eval_matches_jax(time_only, min_twidth, min_bin_content):
    """The variable-bin estimator, in its nearest-neighbour branch (a tiny
    window) and its fixed-window branch, 1D and with the 2D box metric."""
    hit, t, q = _event(5)
    pdfs = JGPUPDF(), GPUPDF()
    for pdf in pdfs:
        pdf.setup_pdf_eval(hit, t, q, min_twidth, TRANGE, 2.0, QRANGE,
                           min_bin_content=min_bin_content,
                           time_only=time_only)
    _feed('accumulate_pdf_eval', pdfs, _batches(6, 16, 7), 16)
    jpdf, ppdf = pdfs
    assert np.array_equal(np.asarray(jpdf.eval_hitcount),
                          ppdf.get_pdf_eval()[0])
    jnear, pnear = np.asarray(jpdf.nearest_mc), ppdf.nearest_mc
    assert pnear.dtype == np.float32 and pnear.shape == jnear.shape
    assert np.array_equal(jnear.view(np.int32), pnear.view(np.int32))
    ref, out = jpdf.get_pdf_eval(), ppdf.get_pdf_eval()
    assert ref[0].dtype == out[0].dtype == np.uint32
    assert np.array_equal(ref[0], out[0])
    for a, b in zip(ref[1:], out[1:]):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0.0)
    assert (out[1][hit] > 0).mean() > 0.9 and not out[1][~hit].any()
    high = min_twidth > 1.0
    assert (np.asarray(jpdf.eval_bincount) >= min_bin_content).any() == high


def test_pdf_eval_unhit_readout_and_empty():
    """A readout in which nothing is hit (every t = 1e9) adds nothing;
    with no readout at all the estimator returns zeros."""
    hit, t, q = _event(9)
    pdf = GPUPDF()
    pdf.setup_pdf_eval(hit, t, q, 0.5, TRANGE, 1.0, QRANGE,
                       min_bin_content=4)
    count, value, err = pdf.get_pdf_eval()
    assert not count.any() and not value.any() and not err.any()
    pdf.accumulate_pdf_eval(Channels(np.full(4 * NCH, 1e9, np.float32),
                                     np.zeros(4 * NCH, np.float32), 4,
                                     torch.from_numpy))
    count, value, err = pdf.get_pdf_eval()
    assert not count.any() and not value.any()
    assert (pdf.nearest_mc == np.float32(1e9)).all()


@pytest.mark.parametrize('time_only', [True, False])
def test_kernel_pdf_matches_jax(time_only):
    hit, t, q = _event(11)
    pdfs = JGPUKernelPDF(), GPUKernelPDF()
    for pdf in pdfs:
        pdf.setup_moments(NCH, TRANGE, QRANGE, time_only=time_only)
    _feed('accumulate_moments', pdfs, _batches(40, 1, 13), 1)
    for pdf in pdfs:
        pdf.compute_bandwidth(hit, t, q, scale_factor=2.0)
        pdf.setup_kernel(hit, t, q)
    jpdf, ppdf = pdfs
    for name in ('inv_time_bandwidths', 'inv_charge_bandwidths'):
        a, b = np.asarray(getattr(jpdf, name)), getattr(ppdf, name)
        assert b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=KDE_RTOL, atol=0.0)
    assert (ppdf.inv_time_bandwidths > 0).mean() > 0.9
    _feed('accumulate_kernel', pdfs, _batches(40, 1, 17), 1)
    ref, out = jpdf.get_kernel_eval(), ppdf.get_kernel_eval()
    assert ref[0].dtype == out[0].dtype == np.uint32
    assert np.array_equal(ref[0], out[0])
    np.testing.assert_allclose(out[1], ref[1], rtol=KDE_RTOL, atol=0.0)
    assert (out[1][hit] > 0).all() and not out[1][~hit].any()
    assert not out[2].any()
