"""Iterator helpers (parity: chroma/itertoolset.py)."""
from copy import deepcopy
from itertools import chain, cycle, islice, repeat, starmap, zip_longest


def peek(iterable):
    """(first_element, equivalent_iterable)."""
    it = iter(iterable)
    first_element = next(it)
    return first_element, chain([first_element], it)


def repeatfunc(func, times=None, *args):
    if times is None:
        return starmap(func, repeat(args))
    return starmap(func, repeat(args, times))


def repeatcopy(obj, times=None):
    if times is None:
        while True:
            yield deepcopy(obj)
    else:
        for _ in range(times):
            yield obj


def repeating_iterator(i, nreps):
    """Emit each element of ``i`` ``nreps`` times (deep copies)."""
    for item in i:
        for _ in range(nreps):
            yield deepcopy(item)


def grouper(n, iterable, fillvalue=None):
    args = [iter(iterable)] * n
    return zip_longest(fillvalue=fillvalue, *args)


def roundrobin(*iterables):
    pending = len(iterables)
    nexts = cycle(iter(it).__next__ for it in iterables)
    while pending:
        try:
            for nxt in nexts:
                yield nxt()
        except StopIteration:
            pending -= 1
            nexts = cycle(islice(nexts, pending))


def take(n, iterable):
    return list(islice(iterable, n))
