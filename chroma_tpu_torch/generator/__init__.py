"""Photon/vertex generation (parity: chroma/generator/)."""
from chroma_tpu_torch.generator import vertex
from chroma_tpu_torch.generator import photon
from chroma_tpu_torch.generator.photon import (G4ParallelGenerator,
                                               ParametricGenerator,
                                               photon_bomb)

__all__ = ['vertex', 'photon', 'G4ParallelGenerator',
           'ParametricGenerator', 'photon_bomb']
