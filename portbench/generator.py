"""The one traffic generator.

A traffic mix is a data file, ``traffic/<name>.json``.  Its ``source``
names a kind, and ``sources/<kind>.py`` makes the input bank from the
source's parameters, the configuration and the seed; its ``entry``
names how the program is driven, ``entries/<entry>.py``.  A mix of a
kind and entry the benchmark has is data alone; a new kind or entry is
a new file beside the others, found by its name.

Here too: the seeds of a run's independent uses, and the order in which
calls draw events from a bank.
"""
import numpy as np

from portbench import plugins


def stream_seeds(seed, names=('bank', 'order', 'sim', 'check')):
    """Independent 62-bit seeds, one a named use, from ``--seed``."""
    children = np.random.SeedSequence(int(seed)).spawn(len(names))
    return {name: int(c.generate_state(1, np.uint64)[0] >> np.uint64(2))
            for name, c in zip(names, children)}


def make_bank(source, cfg, seed, device, bench=plugins.BENCH_DIR):
    """The input bank of ``source`` (a traffic file's ``source``): its
    kind's ``make_bank(source, cfg, seed, device)``."""
    return plugins.find(bench, 'sources', source['kind']).make_bank(
        source, cfg, seed, device)


class EventOrder(object):
    """The events each call draws from the bank: a fresh permutation of
    the bank from the seed, taken in turn until the call holds at least
    ``photons_per_batch`` photons.  No event appears twice in a call:
    ``Simulation.simulate`` writes each event's index into its photons,
    so one Photons object in two places of a batch would carry the
    second's index in both."""

    def __init__(self, counts, photons_per_batch, seed):
        self.counts = np.asarray(counts)
        self.target = int(photons_per_batch)
        if self.counts.sum() < self.target:
            raise ValueError('the bank holds %d photons, fewer than a call '
                             'of %d' % (self.counts.sum(), self.target))
        self.rng = np.random.Generator(np.random.PCG64(seed))

    def next_call(self):
        ids, total = [], 0
        for k in self.rng.permutation(len(self.counts)):
            if total >= self.target:
                break
            ids.append(int(k))
            total += int(self.counts[k])
        return ids, total
