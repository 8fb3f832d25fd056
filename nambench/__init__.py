"""nambench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 nambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

  configs/<config>.json      the deployment's sizes and guarantees
  traffic/<traffic>.json     a mix's parameters; its ``kind`` names the
                             general driver in ``kinds/`` that reads it
  metrics/<metric>.py        a reader of one metric (``read(ctx)``);
                             ``metrics/<metric>.kernels.json`` lists the
                             device kernels a roofline sums
  reference/                 the plain references (NumPy and plain torch,
                             nothing of the port) that decide ``correct``

The frozen yardstick (peaks and byte counts) is ``roofline.py``; the
profiler's reduction is ``trace.py``; ``faults.py`` holds the planted
controls and faults, and ``controls.py`` runs them on seeds.
"""
