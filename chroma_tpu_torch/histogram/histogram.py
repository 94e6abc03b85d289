"""1D histogram with Poisson-ish error tracking (parity:
chroma/histogram/histogram.py, without the external uncertainties
dependency — errors are plain float arrays).  A copy of
chroma_tpu/histogram/histogram.py for the port."""
import numpy as np


class Histogram(object):
    def __init__(self, bins=10, range=(-0.5, 9.5)):
        if np.isscalar(bins):
            self.bins = np.linspace(range[0], range[1], int(bins) + 1)
        else:
            self.bins = np.asarray(bins, dtype=float)
            if (np.diff(self.bins) < 0).any():
                raise AttributeError('bins must increase monotonically.')

        self.bincenters = 0.5 * (self.bins[1:] + self.bins[:-1])
        self.errs = np.zeros(self.bins.size - 1)
        self.hist = np.zeros(self.bins.size - 1)
        self.nentries = 0

    def fill(self, x):
        """Add sample(s) ``x`` to the histogram."""
        add = np.histogram(np.atleast_1d(x), self.bins)[0]
        self.hist += add
        self.errs = np.sqrt(self.errs ** 2 + add)
        self.nentries += np.size(x)

    def findbin(self, x):
        """Index of the bin containing ``x`` (clipped)."""
        return np.clip(np.searchsorted(self.bins, x, side='right') - 1,
                       0, len(self.hist) - 1)

    def eval(self, x):
        """Histogram content at ``x``."""
        return self.hist[self.findbin(x)]

    def ueval(self, x):
        """(value, error) at ``x``."""
        idx = self.findbin(x)
        return self.hist[idx], self.errs[idx]

    def interp(self, x):
        """Linear interpolation between bin centers."""
        return np.interp(x, self.bincenters, self.hist)

    def mean(self):
        return np.dot(self.bincenters, self.hist) / max(self.hist.sum(),
                                                        1e-300)

    def reset(self):
        self.hist[:] = 0
        self.errs[:] = 0
        self.nentries = 0

    def scale(self, c):
        self.hist *= c
        self.errs *= abs(c)

    def normalize(self):
        """Normalize to unit area (by bin width)."""
        widths = np.diff(self.bins)
        total = (self.hist * widths).sum()
        if total > 0:
            self.scale(1.0 / total)

    def __add__(self, other):
        h = Histogram(self.bins)
        h.hist = self.hist + other.hist
        h.errs = np.sqrt(self.errs ** 2 + other.errs ** 2)
        h.nentries = self.nentries + other.nentries
        return h
