"""GDML/RATDB geometry import (the port's copy of chroma_tpu/rat)."""
from chroma_tpu_torch.rat.loader import RATGeoLoader, Volume
from chroma_tpu_torch.rat.ratdb_parser import RatDBParser

__all__ = ['RATGeoLoader', 'Volume', 'RatDBParser']
