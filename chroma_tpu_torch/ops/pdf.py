"""PDF accumulation and likelihood estimators.

Counterpart of chroma_tpu/ops/pdf.py (reference: chroma/gpu/pdf.py and
chroma/cuda/pdf.cu):

* ``GPUPDF.setup_pdf`` / ``add_hits_to_pdf``: the binned (channel, time,
  charge) histogram, one flat ``index_add_``;
* ``GPUPDF.setup_pdf_eval`` / ``accumulate_pdf_eval``: the variable-bin
  estimator.  Per-channel counts are dense elementwise ops, and the
  nearest-neighbour distance list of each hit channel is a sorted
  (nhit, K) table merged with every batch by one sort;
* ``GPUKernelPDF``: per-channel Gaussian KDE with Silverman-style
  bandwidths, erf-normalized in the PDF time window.

The accumulators live on the device of the channel readouts they are
fed (``ops/daq.GPUChannels``: flat ``t`` and ``q`` tensors and ``ndaq``).
Counters are int32/int64 tensors; what ``get_*`` returns has the JAX
package's numpy dtypes (uint32 counts).  The bin edges differ on
purpose, as in the reference: ``add_hits_to_pdf`` takes ``t < tmax``,
the variable-bin and kernel estimators ``t <= tmax``.
"""
import numpy as np
import torch


def _u32(counts):
    """An integer counter tensor as the JAX package's uint32 array."""
    return counts.cpu().numpy().astype(np.uint32)


class GPUPDF(object):
    """Binned PDFs and variable-bin PDF evaluation (parity:
    chroma/gpu/pdf.py GPUPDF)."""

    # ---- binned 3D (channel, t, q) PDFs --------------------------------

    def setup_pdf(self, nchannels, tbins, trange, qbins, qrange):
        self.events_in_histogram = 0
        self.nchannels = nchannels
        self.tbins = tbins
        self.trange = trange
        self.qbins = qbins
        self.qrange = qrange
        self.hitcount = None    # allocated on the first readout's device
        self.pdf = None

    def clear_pdf(self):
        if self.hitcount is not None:
            self.hitcount.zero_()
            self.pdf.zero_()

    def add_hits_to_pdf(self, gpuchannels):
        t = gpuchannels.t[:self.nchannels]
        q = gpuchannels.q[:self.nchannels]
        if self.hitcount is None:
            self.hitcount = torch.zeros(self.nchannels, dtype=torch.int32,
                                        device=t.device)
            # one spare slot at the end takes the channels that miss
            self.pdf = torch.zeros(
                self.nchannels * self.tbins * self.qbins + 1,
                dtype=torch.int32, device=t.device)
        tmin, tmax = self.trange
        qmin, qmax = self.qrange
        ok = (t < 1e8) & (t >= tmin) & (t < tmax) & (q >= qmin) & (q < qmax)
        self.hitcount += ok.to(torch.int32)
        # an unhit channel holds t = 1e9, out of an int32's range: mask
        # before the cast
        zero = torch.zeros_like(t)
        tbin = (torch.where(ok, t - tmin, zero) / (tmax - tmin)
                * self.tbins).to(torch.int64)
        qbin = (torch.where(ok, q - qmin, zero) / (qmax - qmin)
                * self.qbins).to(torch.int64)
        flat = torch.arange(self.nchannels, device=t.device) \
            * (self.tbins * self.qbins) + tbin * self.qbins + qbin
        flat = torch.where(ok, flat, self.pdf.numel() - 1)
        self.pdf.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
        self.events_in_histogram += 1

    def get_pdfs(self):
        """(hitcount (nchannels,), pdf (nchannels, tbins, qbins)), both
        uint32."""
        shape = (self.nchannels, self.tbins, self.qbins)
        if self.hitcount is None:
            return np.zeros(self.nchannels, np.uint32), \
                np.zeros(shape, np.uint32)
        return _u32(self.hitcount), _u32(self.pdf[:-1]).reshape(shape)

    # ---- variable-bin PDF evaluation -----------------------------------

    def setup_pdf_eval(self, event_hit, event_time, event_charge,
                       min_twidth, trange, min_qwidth, qrange,
                       min_bin_content=10, time_only=True):
        """Variable-bin PDF evaluation at each channel's (t[, q]) point.

        ``time_only=False`` evaluates a 2D (time, charge) density: the
        nearest-neighbour metric is the box-normalized distance
        max(|dt| / min_twidth, |dq| / min_qwidth), so the adaptive bin
        is a box scaled uniformly in both axes."""
        self.event_hit = np.asarray(event_hit).astype(bool)
        self.nchannels = len(self.event_hit)
        self.event_nhit = int(self.event_hit.sum())
        self.map_hit_offset_to_channel_id = \
            np.where(self.event_hit)[0].astype(np.int32)
        self.event_time = np.asarray(event_time, dtype=np.float32)
        self.event_charge = np.asarray(event_charge, dtype=np.float32)
        self.min_twidth = min_twidth
        self.trange = trange
        self.min_qwidth = min_qwidth
        self.qrange = qrange
        self.min_bin_content = min_bin_content
        self.time_only = time_only
        self.clear_pdf_eval()

    def clear_pdf_eval(self):
        self._eval = None       # allocated on the first readout's device

    def _eval_state(self, device):
        if self._eval is None:
            def dev(a):
                return torch.from_numpy(a).to(device)
            self._eval = dict(
                hit=dev(self.event_hit), time=dev(self.event_time),
                charge=dev(self.event_charge),
                hit_ids=dev(self.map_hit_offset_to_channel_id
                            .astype(np.int64)),
                hitcount=torch.zeros(self.nchannels, dtype=torch.int64,
                                     device=device),
                bincount=torch.zeros(self.nchannels, dtype=torch.int64,
                                     device=device),
                nearest_mc=torch.full(
                    (self.event_nhit, self.min_bin_content), 1e9,
                    dtype=torch.float32, device=device))
        return self._eval

    def accumulate_pdf_eval(self, gpuchannels):
        """Fold one (possibly multi-DAQ) channel readout into the
        estimator (reference: chroma/cuda/pdf.cu accumulate_bincount and
        accumulate_nearest_neighbor_block)."""
        ndaq = gpuchannels.ndaq
        mc_t = gpuchannels.t.reshape(ndaq, self.nchannels)
        ev = self._eval_state(mc_t.device)
        tmin, tmax = self.trange

        in_pdf = (mc_t < 1e8) & (mc_t >= tmin) & (mc_t <= tmax)
        if not self.time_only:
            mc_q = gpuchannels.q.reshape(ndaq, self.nchannels)
            qmin, qmax = self.qrange
            in_pdf = in_pdf & (mc_q >= qmin) & (mc_q <= qmax)
        ev['hitcount'] += in_pdf.sum(dim=0)

        if self.time_only:
            dist = torch.abs(mc_t - ev['time'][None, :])
            close = in_pdf & (dist < self.min_twidth / 2.0) \
                & ev['hit'][None, :]
        else:
            # box-normalized 2D distance: 0.5 at the min-bin boundary
            dist = torch.maximum(
                torch.abs(mc_t - ev['time'][None, :]) / self.min_twidth,
                torch.abs(mc_q - ev['charge'][None, :]) / self.min_qwidth)
            close = in_pdf & (dist < 0.5) & ev['hit'][None, :]
        ev['bincount'] += close.sum(dim=0)

        # nearest-neighbour table of the hit channels: merge this
        # batch's distances into the running K smallest
        hit_ids = ev['hit_ids']
        d_hit = torch.where(in_pdf[:, hit_ids], dist[:, hit_ids], 1e9).T
        merged = torch.cat([ev['nearest_mc'], d_hit], dim=1)
        ev['nearest_mc'] = torch.sort(merged, dim=1)[0][
            :, :self.min_bin_content]

    @property
    def nearest_mc(self):
        """(nhit, min_bin_content) float32: each hit channel's smallest
        distances so far, ascending, 1e9 where there is none."""
        if self._eval is None:
            return np.full((self.event_nhit, self.min_bin_content), 1e9,
                           np.float32)
        return self._eval['nearest_mc'].cpu().numpy()

    def get_pdf_eval(self):
        """(hitcount, pdf_value, pdf_uncertainty) per channel
        (reference: chroma/gpu/pdf.py get_pdf_eval)."""
        evhit = self.event_hit
        if self._eval is None:
            hitcount = np.zeros(self.nchannels, np.uint32)
            bincount = np.zeros(self.nchannels, np.uint32)
        else:
            hitcount = _u32(self._eval['hitcount'])
            bincount = _u32(self._eval['bincount'])

        pdf_value = np.zeros(len(hitcount), dtype=float)
        pdf_frac_uncert = np.zeros_like(pdf_value)

        bin_measure = self.min_twidth if self.time_only \
            else self.min_twidth * self.min_qwidth
        high_stats = bincount >= self.min_bin_content
        if high_stats.any():
            pdf_value[high_stats] = bincount[high_stats].astype(float) \
                / hitcount[high_stats] / bin_measure
            pdf_frac_uncert[high_stats] = 1.0 / np.sqrt(bincount[high_stats])

        low_stats = ~high_stats & (hitcount > 0) & evhit
        nearest_mc = np.full((len(hitcount), self.min_bin_content), 1e9,
                             dtype=np.float32)
        nearest_mc[self.map_hit_offset_to_channel_id, :] = self.nearest_mc
        last_valid = np.maximum(0, (nearest_mc < 1e9).sum(axis=1) - 1)
        distance = nearest_mc[np.arange(len(last_valid)), last_valid]
        if low_stats.any():
            k = (last_valid[low_stats] + 1).astype(float)
            if self.time_only:
                # window of width 2*distance around the event time
                measure = 2.0 * distance[low_stats]
            else:
                # box scaled by the normalized distance u: area
                # (2u*min_twidth) x (2u*min_qwidth)
                u = distance[low_stats]
                measure = 4.0 * u * u * self.min_twidth * self.min_qwidth
            pdf_value[low_stats] = k / hitcount[low_stats] / measure
            pdf_frac_uncert[low_stats] = 1.0 / np.sqrt(
                last_valid[low_stats] + 1)

        return hitcount, pdf_value, pdf_value * pdf_frac_uncert


class GPUKernelPDF(object):
    """Per-channel Gaussian KDE PDFs (parity: chroma/gpu/pdf.py
    GPUKernelPDF)."""

    def setup_moments(self, nchannels, trange, qrange, time_only=True):
        self.nchannels = nchannels
        self.trange = trange
        self.qrange = qrange
        self.time_only = time_only
        self.clear_moments()

    def clear_moments(self):
        self._mom = None        # allocated on the first readout's device

    def _ok(self, t, q):
        tmin, tmax = self.trange
        ok = (t >= tmin) & (t <= tmax)
        if not self.time_only:
            qmin, qmax = self.qrange
            ok = ok & (q >= qmin) & (q <= qmax)
        return ok

    def accumulate_moments(self, gpuchannels):
        t = gpuchannels.t[:self.nchannels]
        q = gpuchannels.q[:self.nchannels]
        if self._mom is None:
            z = torch.zeros(self.nchannels, dtype=torch.float32,
                            device=t.device)
            self._mom = dict(hitcount=z.to(torch.int32), tmom1=z.clone(),
                             tmom2=z.clone(), qmom1=z.clone(),
                             qmom2=z.clone())
        m = self._mom
        ok = self._ok(t, q)
        okf = ok.to(torch.float32)
        m['hitcount'] += ok.to(torch.int32)
        m['tmom1'] += okf * t
        m['tmom2'] += okf * t * t
        if not self.time_only:
            m['qmom1'] += okf * q
            m['qmom2'] += okf * q * q

    def _moment(self, name, dtype):
        if self._mom is None:
            return np.zeros(self.nchannels, dtype)
        return self._mom[name].cpu().numpy().astype(dtype)

    def compute_bandwidth(self, event_hit, event_time, event_charge,
                          scale_factor=1.0):
        """Silverman-style per-channel bandwidths (reference:
        chroma/gpu/pdf.py:61-112), on the host."""
        rho = 1.0
        hitcount = self._moment('hitcount', np.uint32)
        mom0 = np.maximum(hitcount, 1)
        d = 1 if self.time_only else 2
        dim_factor = ((4.0 / (d + 2)) / (mom0 / scale_factor)) \
            ** (-1.0 / (d + 4))

        def inv_bandwidth(mom1, mom2, at):
            mean = self._moment(mom1, np.float32) / mom0
            rms = np.sqrt(np.maximum(
                self._moment(mom2, np.float32) / mom0 - mean ** 2, 0.0))
            with np.errstate(divide='ignore', invalid='ignore'):
                gauss_density = np.minimum(
                    1.0 / rms,
                    (1.0 / np.sqrt(2.0 * np.pi))
                    * np.exp(-0.5 * ((at - mean) / rms)) / rms)
                bw = dim_factor / gauss_density * rho
                inv = np.where(bw > 0, 1.0 / bw, 0.0)
            return np.nan_to_num(inv, nan=0.0, posinf=0.0, neginf=0.0) \
                .astype(np.float32)

        self.inv_time_bandwidths = inv_bandwidth('tmom1', 'tmom2',
                                                 event_time)
        if self.time_only:
            self.inv_charge_bandwidths = np.zeros(self.nchannels,
                                                  np.float32)
        else:
            self.inv_charge_bandwidths = inv_bandwidth('qmom1', 'qmom2',
                                                       event_charge)

    def setup_kernel(self, event_hit, event_time, event_charge):
        self.event_hit = np.asarray(event_hit).astype(bool)
        self.event_time = np.asarray(event_time, dtype=np.float32)
        self.event_charge = np.asarray(event_charge, dtype=np.float32)
        self.clear_kernel()

    def clear_kernel(self):
        self._ker = None        # allocated on the first readout's device

    def _kernel_term(self, x, at, inv_bw, lo, hi, with_width):
        """exp(-arg^2 / 2) [* inv_bw] over its erf normalization in
        [lo, hi]; a channel without a bandwidth is flat over the window."""
        invroot2 = 0.70710678118654746
        root_pi_by_2 = 1.2533141373155001
        arg = (x - at) * inv_bw
        term = torch.exp(-0.5 * arg * arg)
        if with_width:
            term = term * inv_bw
        erf = torch.special.erf
        norm = torch.where(
            inv_bw > 0,
            (erf((hi - x) * inv_bw * invroot2)
             - erf((lo - x) * inv_bw * invroot2)) * root_pi_by_2,
            float(hi - lo))
        # far outside the window the normalization underflows to 0
        return term / torch.clamp(norm, min=1e-30)

    def accumulate_kernel(self, gpuchannels):
        """erf-normalized Gaussian KDE accumulation (reference:
        chroma/cuda/pdf.cu accumulate_kernel_eval)."""
        t = gpuchannels.t[:self.nchannels]
        q = gpuchannels.q[:self.nchannels]
        if self._ker is None:
            def dev(a):
                return torch.from_numpy(np.asarray(a)).to(t.device)
            z = torch.zeros(self.nchannels, dtype=torch.float32,
                            device=t.device)
            self._ker = dict(
                hit=dev(self.event_hit), time=dev(self.event_time),
                charge=dev(self.event_charge),
                inv_tbw=dev(self.inv_time_bandwidths),
                inv_qbw=dev(self.inv_charge_bandwidths),
                hitcount=z.to(torch.int32), tvals=z.clone(),
                qvals=z.clone())
        k = self._ker
        ok = self._ok(t, q)
        k['hitcount'] += ok.to(torch.int32)
        contrib = ok & k['hit']
        zero = torch.zeros_like(t)
        tmin, tmax = self.trange
        k['tvals'] += torch.where(contrib, self._kernel_term(
            t, k['time'], k['inv_tbw'], tmin, tmax, True), zero)
        if not self.time_only:
            qmin, qmax = self.qrange
            k['qvals'] += torch.where(contrib, self._kernel_term(
                q, k['charge'], k['inv_qbw'], qmin, qmax, False), zero)

    def get_kernel_eval(self):
        """(hitcount uint32, pdf values, zeros) per channel."""
        if self._ker is None:
            hitcount = np.zeros(self.nchannels, np.uint32)
            tvals = qvals = np.zeros(self.nchannels, np.float32)
        else:
            hitcount = _u32(self._ker['hitcount'])
            tvals = self._ker['tvals'].cpu().numpy()
            qvals = self._ker['qvals'].cpu().numpy()
        pdf_values = tvals / np.maximum(1, hitcount)
        if not self.time_only:
            pdf_values = pdf_values * (qvals / np.maximum(1, hitcount))
        return hitcount, pdf_values, np.zeros_like(pdf_values)
