"""One reader a metric, ``<metric name>.py``, each with ``read(run)``: the
metric's value from the run (``bench.harness.cell.Run``), or None where the
run holds nothing to read."""
