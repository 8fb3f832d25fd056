"""The port's hand-written Hopper kernels, their plain versions and the
dispatch between them (``ops``).  Nothing is built at import: see
``build``."""
