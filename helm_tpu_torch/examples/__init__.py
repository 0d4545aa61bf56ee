"""Worked examples of the helm_tpu_torch library API."""
