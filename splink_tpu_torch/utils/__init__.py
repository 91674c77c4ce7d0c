"""Host-side utilities of splink_tpu_torch."""
