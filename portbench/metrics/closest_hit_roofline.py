"""Share (%) of its bytes bound that the closest-hit walk reaches in the
traced calls: the least time the bytes its inputs need could take at the
card's HBM rate, over the device time of every kernel the call launches.
Bytes per call: each ray's origin, direction, last hit and active flag
read once, its hit written once, the MBVH table read once, or one row a
ray where a call has fewer rays than the table rows.  Layer:
ops/mbvh.intersect_mesh -> csrc/mbvh_walk.cu (K1/K2)."""
from portbench.peaks import H100_SXM
from portbench.spans import nbytes, spanned
from portbench.trace import kernel_seconds

KERNELS = ('closest_hit_kernel',)


def instrument(counters):
    """A span around every walker call and a counter of the bytes it
    needs: (rays, bytes)."""
    from chroma_tpu_torch.ops import mbvh_walk
    counters.closest_hit = []

    def on_call(args, kwargs, out):
        rows, org = args[0], args[1]
        n = org.shape[0]
        row_bytes = rows.shape[1] * rows.element_size()
        io = sum(nbytes(a) for a in args[1:5]) \
            + sum(nbytes(v) for v in out.values())
        counters.closest_hit.append(
            (n, io + min(nbytes(rows), n * row_bytes)))

    return [(mbvh_walk, name, spanned('closest_hit', on_call))
            for name in ('closest_hit_cuda', 'closest_hit_plain')]


def read(ctx):
    calls = ctx['traced']['counters'].closest_hit
    seconds = kernel_seconds(ctx['trace'], KERNELS)
    if not calls or seconds <= 0:
        return None
    bound = sum(b for _, b in calls) / H100_SXM['hbm_bytes_per_s']
    return 100.0 * bound / seconds
