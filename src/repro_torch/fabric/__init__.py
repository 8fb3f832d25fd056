"""repro_torch.fabric — the one-sided verb fabric, ported to PyTorch.

  verbs      read / write / cas / fetch_add over named regions
             (``NamPool``), in place; async variants on transports return
             a ``Completion``
  route()    the radix-into-fixed-buffers router: one packed wire buffer
             per route, ``RoutePlan``/``plan_route`` for slot reuse; on
             the card the rank and the scatter are hand-written kernels
  transports ``LocalTransport`` (one shard), counting messages and bytes
             per verb
  netsim     ``NetworkProfile`` presets for the paper's 1GbE -> EDR axis
"""
from repro_torch.fabric.netsim import (ALIASES, PROFILES, NetworkProfile,
                                       from_counters, get_profile)
from repro_torch.fabric.router import (RoutePlan, RouteResult, bucket_ranks,
                                       pack_fields, packed_row_words,
                                       plan_route, route, unpack_fields)
from repro_torch.fabric.transport import LocalTransport, Transport
from repro_torch.fabric.verbs import (Completion, NamPool, Region, cas,
                                      fetch_add, read, write)

__all__ = [
    "NamPool", "Region", "read", "write", "cas", "fetch_add", "Completion",
    "route", "RouteResult", "RoutePlan", "plan_route", "bucket_ranks",
    "pack_fields", "unpack_fields", "packed_row_words",
    "Transport", "LocalTransport",
    "NetworkProfile", "PROFILES", "ALIASES", "get_profile", "from_counters",
]
