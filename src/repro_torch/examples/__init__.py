"""The example scripts of the port (twins of ``examples/*.py``): each has
``main(argv=None)`` with ``--device`` (default: the card) and returns
what it printed as a dict.

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
  PYTHONPATH=src python -m repro_torch.examples.nam_oltp --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
  PYTHONPATH=src python -m repro_torch.examples.train_lm --tiny --steps 10 --device cpu
"""
