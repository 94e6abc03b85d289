"""Entry ``eval_pdf_tiny`` (a test's new entry): ``Simulation.eval_pdf``
of one bank event a call against the readout of event 0, simulated at
set-up.  A call's unit of work is one evaluation."""
import numpy as np


class Entry(object):

    def __init__(self, gg, traffic, bank, seeds, device):
        from chroma_tpu_torch.event import Photons
        from chroma_tpu_torch.sim import Simulation
        self.sim = Simulation(gg, seed=seeds['sim'] % (2 ** 31),
                              driver=traffic['driver'])
        off = bank['offsets']
        self.photons = [
            Photons(pos=bank['pos'][a:b], dir=bank['dir'][a:b],
                    pol=bank['pol'][a:b],
                    wavelengths=bank['wavelengths'][a:b], t=bank['t'][a:b])
            for a, b in zip(off[:-1], off[1:])]
        ev = next(self.sim.simulate([self.photons[0]], run_daq=True,
                                    keep_hits=False))
        self.observed = ev.channels
        self.rng = np.random.Generator(np.random.PCG64(seeds['order']))
        self.args = traffic['eval_pdf']

    def next(self):
        return int(self.rng.integers(1, len(self.photons))), 1

    def call(self, k):
        a = self.args
        return self.sim.eval_pdf(
            self.observed, [self.photons[k]], a['min_twidth'],
            tuple(a['trange']), a['min_qwidth'], tuple(a['qrange']),
            min_bin_content=a['min_bin_content'], nreps=a['nreps'],
            ndaq=a['ndaq'])

    def samples(self, calls, n, seed):
        return [tuple(np.asarray(x) for x in out) for _, out in calls[:n]]

    @staticmethod
    def lower_precision(sample):
        return sample

    def close(self):
        del self.sim, self.photons
