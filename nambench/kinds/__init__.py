"""The general drivers, one for each ``kind`` a traffic file names.

Each module gives ``setup(config, traffic, seed, device)`` (data, the
program's objects, warm-up), ``unit(state)`` (one closed-loop request,
returning its record) and ``check(state)`` (the comparison with the plain
reference, as (name, value, limit) triples).  A driver reads every size
and rate from its configuration and traffic files.
"""
