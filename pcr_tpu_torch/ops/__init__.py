"""Torch forms of the reduction finalizes (the registry is pcr_tpu's)."""
