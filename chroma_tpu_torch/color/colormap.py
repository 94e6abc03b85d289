"""Map scalar values to packed ARGB colors via matplotlib colormaps
(counterpart of chroma_tpu/color/colormap.py; reference:
chroma/color/colormap.py).  matplotlib is imported by the call, not by
the module: the card's machine has none."""
import numpy as np


def map_to_color(a, range=None, map_name='jet', weights=None):
    """(n,) scalars -> (n,) uint32 0xRRGGBB colors."""
    import matplotlib
    a = np.asarray(a, dtype=float)
    if range is None:
        range = (a.min(), a.max())
    lo, hi = range
    frac = np.clip((a - lo) / max(hi - lo, 1e-300), 0.0, 1.0)
    try:
        cmap = matplotlib.colormaps[map_name]
    except (AttributeError, KeyError):
        from matplotlib import cm
        cmap = cm.get_cmap(map_name)
    rgba = cmap(frac)
    if weights is not None:
        rgba[:, :3] *= np.clip(np.asarray(weights), 0, 1)[:, None]
    rgb = (rgba[:, :3] * 255).astype(np.uint32)
    return (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
