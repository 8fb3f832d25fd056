"""The serving engine of the port (dense mode)."""
from repro_torch.serving.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
