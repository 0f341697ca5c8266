"""The benchmark of vidtome_torch: ``python3 benchmark/run.py``."""
