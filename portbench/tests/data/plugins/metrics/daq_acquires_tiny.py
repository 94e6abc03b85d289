"""A test's new metric with a counter of its own: ``GPUDaq.acquire``
calls per PDF evaluation."""


def instrument(counters):
    from chroma_tpu_torch import gpu
    counters.acquires = []

    def wrap(fn):
        def inner(*args, **kwargs):
            counters.acquires.append(1)
            return fn(*args, **kwargs)
        return inner
    return [(gpu.GPUDaq, 'acquire', wrap)]


def read(ctx):
    part = ctx['traced']
    n = len(getattr(part['counters'], 'acquires', []))
    return n / part['work'] if n and part['work'] else None
