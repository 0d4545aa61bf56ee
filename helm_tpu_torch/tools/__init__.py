"""Diagnostic tools of helm_tpu_torch."""
