"""Event IO (parity: chroma/io).

Formats:
  * chroma_tpu_torch.io.npz: self-contained numpy event files, the same
    format as chroma_tpu.io.npz (a file written by either package is
    read by the other).
  * chroma_tpu_torch.io.root: ROOT event files (requires a ROOT
    install, like the reference's chroma/io/root.py)
  * chroma_tpu_torch.io.ntuple: flat uproot/awkward ntuples (requires
    uproot, like the reference's chroma/io/ntuple.py)
"""
