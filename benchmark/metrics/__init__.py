"""One reader a per-layer metric: ``<metric>.py`` holds ``read(records)``,
which returns the metric's number from a traced run's records
(``benchmark/harness/trace.reduce``), or None where the run has nothing to
read for it."""
