"""The benchmark of splink_tpu_torch: see ``linkbench.run``."""
