"""Hand-written Hopper kernels and their wrappers (counterpart of helm_tpu.ops)."""
