"""Input / output wire files (the port's copy of helm_tpu.io.csv_io)."""
