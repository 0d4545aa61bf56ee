"""Startup banner (reference: src/ascii.rs).

The port's own copy of `helm_tpu/ascii_art.py`, trimmed to what the port
calls, so that helm_tpu_torch imports nothing of the JAX package; the
tests/test_torch_*.py files hold it against the original.
"""

BANNER = r"""
  _  _ ___ _    __  __     _____ ___ _   _
 | || | __| |  |  \/  |___|_   _| _ \ | | |
 | __ | _|| |__| |\/| |___| | | |  _/ |_| |
 |_||_|___|____|_|  |_|     |_| |_|  \___/
   encrypted circuit evaluation on TPUs
"""


def print_art() -> None:
    print("\x1b[36m" + BANNER + "\x1b[0m")
