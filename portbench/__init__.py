"""The benchmark of blitzdg_tpu_torch (see README.md)."""
