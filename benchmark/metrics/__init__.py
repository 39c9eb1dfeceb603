"""The metrics' readers, one a file named after the metric.

Each has ``read(run)``, where ``run`` is ``run.RunData``: it returns the
metric's value, or None where the run holds nothing for it to read (the
harness then leaves the metric out of the line)."""
