"""Workloads of the port measured on the card (``fig6_rsi``, ``checkout``,
``fig8a_joins``, ``fig8b_agg``) and the helpers that drive them."""
