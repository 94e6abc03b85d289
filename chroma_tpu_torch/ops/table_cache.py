"""On-disk cache of packed device tables, in the JAX package's format.

Counterpart of chroma_tpu/ops/table_cache.py: one ``.npy`` per array
field plus a ``meta.json`` of static fields under
``$CHROMA_TPU_CACHE/tables/<name>``.  Both packages read what either
wrote, with the same staleness checks.  An entry without the escape-rope
walker's files (``nodes``, ``escape``, ``tri_vertices``) loads with
their placeholders; loading never writes.
"""
import json
import os

import numpy as np

from chroma_tpu_torch.device import resolve
from chroma_tpu_torch.bvh.mbvh import (LAYOUT_VERSION, BRANCH, ROW_WIDTH,
                                       TARGET_DEGREE, builder_tag)
from chroma_tpu_torch.ops.geometry_pack import (
    GeometryTables, DetectorTables, LEGACY_PLACEHOLDERS, U32_FIELDS,
    array_fields, static_fields, tables_from_numpy)

_FORMAT_VERSION = 2


def _cache_dir(name):
    base = os.environ.get('CHROMA_TPU_CACHE',
                          os.path.expanduser('~/.chroma_tpu'))
    return os.path.join(base, 'tables', name)


def save_tables(name, geom, det=None):
    """Persist packed tables under CHROMA_TPU_CACHE/tables/<name>."""
    d = _cache_dir(name)
    os.makedirs(d, exist_ok=True)
    meta = {'version': _FORMAT_VERSION, 'has_det': det is not None,
            'mbvh_layout': LAYOUT_VERSION, 'branch': BRANCH,
            'row_width': ROW_WIDTH, 'target_degree': TARGET_DEGREE,
            'builder': builder_tag()}
    for prefix, obj in (('geom', geom), ('det', det)):
        if obj is None:
            continue
        cls = type(obj)
        for f in array_fields(cls):
            a = getattr(obj, f).cpu().numpy()
            if f in U32_FIELDS:
                a = a.view(np.uint32)
            np.save(os.path.join(d, '%s_%s.npy' % (prefix, f)), a)
        meta[prefix] = {f: getattr(obj, f) for f in static_fields(cls)}
    with open(os.path.join(d, 'meta.json'), 'w') as f:
        json.dump(meta, f)


def load_tables(name, device=None):
    """(geom, det) on ``device`` (default: the card) from the table
    cache, or None if the entry is absent or stale."""
    device = resolve(device)
    d = _cache_dir(name)
    metafile = os.path.join(d, 'meta.json')
    if not os.path.exists(metafile):
        return None
    with open(metafile) as f:
        meta = json.load(f)
    # caches from before the knob keys were built with that era's defaults
    if meta.get('version') != _FORMAT_VERSION \
            or meta.get('mbvh_layout') != LAYOUT_VERSION \
            or meta.get('branch', 128) != BRANCH \
            or meta.get('row_width', 840) != ROW_WIDTH \
            or meta.get('target_degree', 96) != TARGET_DEGREE \
            or meta.get('builder', 'grid') != builder_tag():
        return None

    def arrays(prefix, cls):
        out = {}
        for f in array_fields(cls):
            path = os.path.join(d, '%s_%s.npy' % (prefix, f))
            if prefix == 'geom' and f in LEGACY_PLACEHOLDERS \
                    and not os.path.exists(path):
                out[f] = LEGACY_PLACEHOLDERS[f]
            else:
                out[f] = np.load(path)
        return out

    try:
        geom_arrays = arrays('geom', GeometryTables)
        det_arrays = arrays('det', DetectorTables) if meta.get('has_det') \
            else None
        geom, det = tables_from_numpy(geom_arrays, det_arrays, meta, device)
    except (FileNotFoundError, KeyError, TypeError):
        return None
    if geom.mbvh_rows.shape[1] != ROW_WIDTH:
        return None      # stale MBVH layout
    return geom, det
