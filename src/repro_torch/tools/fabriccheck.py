#!/usr/bin/env python
"""fabriccheck: the op-stream lint and the one-sided race detector of the
port's verb fabric (a port of ``tools/fabriccheck.py``).

A thin launcher for ``python -m repro_torch.fabric.check`` that works from
a checkout without ``PYTHONPATH``: it puts the checkout's ``src`` on
``sys.path`` and exits with ``repro_torch.fabric.check.main()``'s code.
Without ``--device`` the checked calls run on the card::

    python src/repro_torch/tools/fabriccheck.py --figure all -q --device cpu
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, os.pardir))

from repro_torch.fabric.check import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
