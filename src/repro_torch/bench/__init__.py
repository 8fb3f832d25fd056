"""Workloads of the port measured on the card (``fig6_rsi``)."""
