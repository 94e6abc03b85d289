"""Histogram utilities (parity: chroma/histogram).  Only ``Histogram``
is carried: it is what ``generator.vertex.from_histogram`` reads."""
from chroma_tpu_torch.histogram.histogram import Histogram

__all__ = ['Histogram']
