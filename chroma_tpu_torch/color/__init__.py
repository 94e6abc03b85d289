"""Color maps for rendering (counterpart of chroma_tpu/color;
reference: chroma/color)."""
from chroma_tpu_torch.color.chromaticity import map_wavelength
from chroma_tpu_torch.color.colormap import map_to_color

__all__ = ['map_wavelength', 'map_to_color']
