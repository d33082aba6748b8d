"""The benchmark of ndsm_tpu_torch (see README.md)."""
