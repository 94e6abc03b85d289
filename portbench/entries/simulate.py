"""Entry ``simulate``: ``Simulation.simulate(events, photons_per_batch,
run_daq, keep_hits, max_steps)`` over events drawn from the bank, each
call a fresh draw of distinct events (``generator.EventOrder``) up to
``photons_per_batch`` photons.  A call's units of work are its photons.

Traffic keys: ``driver``, ``driver_options``, ``photons_per_batch``,
``run_daq``, ``keep_hits``, ``max_steps``.  The check's samples are
events of the window drawn from the seed: (the bank's photons of the
event, its detected photons, its channels), each a dict of numpy
arrays.
"""
import numpy as np
import torch

from portbench import generator


def _bf16(x):
    """``x`` rounded to bfloat16, as a photon state stored in it."""
    return torch.as_tensor(np.ascontiguousarray(x)).to(torch.bfloat16) \
        .to(torch.float32).numpy()


class Entry(object):

    def __init__(self, gg, traffic, bank, seeds, device):
        from chroma_tpu_torch.event import Photons
        from chroma_tpu_torch.sim import Simulation
        self.sim = Simulation(gg, seed=seeds['sim'] % (2 ** 31),
                              driver=traffic['driver'],
                              driver_options=traffic.get('driver_options'))
        self.bank = bank
        off = bank['offsets']
        self.photons = [
            Photons(pos=bank['pos'][a:b], dir=bank['dir'][a:b],
                    pol=bank['pol'][a:b],
                    wavelengths=bank['wavelengths'][a:b], t=bank['t'][a:b])
            for a, b in zip(off[:-1], off[1:])]
        self.order = generator.EventOrder(np.diff(off),
                                          traffic['photons_per_batch'],
                                          seeds['order'])
        self.kw = dict(photons_per_batch=traffic['photons_per_batch'],
                       run_daq=traffic.get('run_daq', True),
                       keep_hits=traffic.get('keep_hits', False),
                       max_steps=traffic.get('max_steps', 100))

    def next(self):
        """(the next call's events, its photons)."""
        return self.order.next_call()

    def call(self, ids):
        return list(self.sim.simulate([self.photons[i] for i in ids],
                                      **self.kw))

    def samples(self, calls, n, seed):
        """``n`` events of the window, drawn from the seed."""
        pairs = [(c, e) for c, (ids, evs) in enumerate(calls)
                 for e in range(len(evs))]
        rng = np.random.Generator(np.random.PCG64(seed))
        pick = rng.choice(len(pairs), size=min(n, len(pairs)),
                          replace=False) if pairs else []
        out = []
        for p in sorted(pick):
            c, e = pairs[p]
            ids, evs = calls[c]
            h, ch = evs[e].flat_hits, evs[e].channels
            out.append((self._emitted(ids[e]),
                        dict(pos=h.pos, dir=h.dir, wavelengths=h.wavelengths,
                             t=h.t, flags=h.flags, channel=h.channel),
                        dict(hit=ch.hit, t=ch.t, q=ch.q, flags=ch.flags)))
        return out

    def _emitted(self, k):
        a, b = self.bank['offsets'][k], self.bank['offsets'][k + 1]
        return {f: self.bank[f][a:b] for f in ('pos', 'dir', 'pol',
                                               'wavelengths', 't')}

    @staticmethod
    def lower_precision(sample):
        """The control: a sample with the program's outputs kept in
        bfloat16, the precision below the configuration's float32."""
        emitted, hits, channels = sample
        hits = dict(hits, pos=_bf16(hits['pos']), t=_bf16(hits['t']))
        channels = dict(channels, t=_bf16(channels['t']),
                        q=_bf16(channels['q']))
        return emitted, hits, channels

    def close(self):
        del self.sim, self.photons
