"""The port's data pipeline (``repro.data``): a deterministic, resumable
synthetic token stream.  JAX's background ``Prefetcher`` is not ported:
no caller needs it yet (ROADMAP queue 1)."""
from repro_torch.data.pipeline import SyntheticLM

__all__ = ["SyntheticLM"]
