"""Event IO (parity: chroma/io).

Formats:
  * chroma_tpu_torch.io.npz: self-contained numpy event files, the same
    format as chroma_tpu.io.npz (a file written by either package is
    read by the other).
The ROOT and ntuple formats of the JAX package are not carried yet.
"""
