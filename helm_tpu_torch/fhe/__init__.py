"""FHE primitives on torch tensors (counterpart of helm_tpu.fhe)."""
