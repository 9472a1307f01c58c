"""Paged-KV continuous-batching decode serving (the port of
paddle_tpu/serving/; see engine.py for what is ported so far)."""
from .cache import BlockAllocator, CacheConfig, PagedKVCache
from .engine import DecodeEngine, EngineConfig
from .request import (Completion, Request, RequestFailedError,
                      RequestHandle, RequestState, ServingError, ShedError)
from .resilience import Health, shed_handle
from .weights import prepare_params

__all__ = ["BlockAllocator", "CacheConfig", "PagedKVCache", "DecodeEngine",
           "EngineConfig", "Completion", "Request", "RequestFailedError",
           "RequestHandle", "RequestState", "ServingError", "ShedError",
           "Health", "shed_handle", "prepare_params"]
