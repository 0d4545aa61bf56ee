"""Circuit engines on torch devices (counterpart of helm_tpu.engines)."""
