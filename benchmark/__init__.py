"""The benchmark of reductive_tpu_torch: see ``benchmark/run.py``."""
