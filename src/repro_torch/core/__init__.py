"""The paper's commit protocols over the port's fabric: RSI (``rsi``) and
the 2PC baseline (``twopc``)."""
from repro_torch.fabric import LocalTransport, NamPool, Region, route

__all__ = ["NamPool", "Region", "LocalTransport", "route"]
