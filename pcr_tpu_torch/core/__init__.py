"""Device probes of the port (the core types are pcr_tpu's)."""
