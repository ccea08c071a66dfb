"""The reduction registry (a copy of pcr_tpu/ops) and its torch finalizes."""
