"""The serving engine of the port: dense and paged modes, and the KV
block codec."""
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.paging import BlockAllocator, PagedKV, PageTable

__all__ = ["ServeEngine", "Request", "PagedKV", "PageTable",
           "BlockAllocator"]
