"""Histogram utilities (counterpart of chroma_tpu/histogram; reference:
chroma/histogram)."""
from chroma_tpu_torch.histogram.histogram import Histogram
from chroma_tpu_torch.histogram.histogramdd import HistogramDD
from chroma_tpu_torch.histogram.graph import Graph

__all__ = ['Histogram', 'HistogramDD', 'Graph']
