"""Device operations on torch tensors (counterparts of chroma_tpu.ops)."""
