"""The benchmark of cpzk_tpu_torch on the card: ``python3 -m benchmark.run``."""
