"""Command-line launchers of the port that run from a checkout without
``PYTHONPATH``."""
