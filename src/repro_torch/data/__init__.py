"""The port's data pipeline (``repro.data``): a deterministic, resumable
synthetic token stream and a background prefetcher whose stream loses no
batch."""
from repro_torch.data.pipeline import Prefetcher, SyntheticLM

__all__ = ["Prefetcher", "SyntheticLM"]
