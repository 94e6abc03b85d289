"""N-dimensional histogram (counterpart of
chroma_tpu/histogram/histogramdd.py; reference:
chroma/histogram/histogramdd.py)."""
import numpy as np


class HistogramDD(object):
    def __init__(self, bins, range=None):
        sample = np.empty((0, len(bins)))
        hist, edges = np.histogramdd(sample, bins=bins, range=range)
        self.hist = hist
        self.bins = [np.asarray(e) for e in edges]
        self.bincenters = [0.5 * (e[1:] + e[:-1]) for e in self.bins]
        self.errs = np.zeros_like(self.hist)
        self.nentries = 0

    def fill(self, x):
        x = np.atleast_2d(x)
        add = np.histogramdd(x, bins=self.bins)[0]
        self.hist += add
        self.errs = np.sqrt(self.errs ** 2 + add)
        self.nentries += len(x)

    def findbin(self, x):
        """Tuple of bin indices for point ``x``."""
        return tuple(
            int(np.clip(np.searchsorted(edges, xi, side='right') - 1, 0,
                        len(edges) - 2))
            for xi, edges in zip(x, self.bins))

    def eval(self, x):
        return self.hist[self.findbin(x)]

    def ueval(self, x):
        idx = self.findbin(x)
        return self.hist[idx], self.errs[idx]

    def reset(self):
        self.hist[:] = 0
        self.errs[:] = 0
        self.nentries = 0

    def scale(self, c):
        self.hist *= c
        self.errs *= abs(c)

    def normalize(self):
        total = self.hist.sum()
        if total > 0:
            self.scale(1.0 / total)
