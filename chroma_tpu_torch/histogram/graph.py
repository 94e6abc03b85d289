"""Simple (x, y, errors) graph container (counterpart of
chroma_tpu/histogram/graph.py; reference: chroma/histogram/graph.py)."""
import numpy as np


class Graph(object):
    def __init__(self, x=(), y=(), xerr=None, yerr=None):
        self.x = np.asarray(x, dtype=float)
        self.y = np.asarray(y, dtype=float)
        if self.x.size != self.y.size:
            raise ValueError('x and y must be the same length')
        self.xerr = np.zeros_like(self.x) if xerr is None \
            else np.asarray(xerr, dtype=float)
        self.yerr = np.zeros_like(self.y) if yerr is None \
            else np.asarray(yerr, dtype=float)

    def size(self):
        return self.x.size
