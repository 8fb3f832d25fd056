"""Workloads of the port measured on the card and the helpers that drive
them; ``run.py`` is the benchmark harness over the nine figures of the
paper's tables and figures (``timing.py`` its median-of-k timer)."""
