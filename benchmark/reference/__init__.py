"""Part of the benchmark of vidtome_torch."""
