"""The port's tools: checkpoint conversion, the parity run and the quality
gates (counterparts of the repo's ``tools/convert_checkpoint.py``,
``parity_run.py`` and ``quality_gate.py``), and ``bench.py``'s serving
profiles (``profiles.py``)."""
