"""Paged-KV continuous-batching decode serving (the port of
paddle_tpu/serving/; see engine.py for what is ported so far)."""
from .cache import (BlockAllocator, CacheConfig, PagedKVCache,
                    RadixPrefixCache)
from .engine import DecodeEngine, EngineConfig
from .request import (Completion, Request, RequestFailedError,
                      RequestHandle, RequestState, ServingError, ShedError)
from .resilience import Health, shed_handle
from .spec import SpecConfig, SpecDecoder
from .weights import dequant_params, prepare_params, quantize_params

__all__ = ["BlockAllocator", "CacheConfig", "PagedKVCache",
           "RadixPrefixCache", "DecodeEngine", "EngineConfig", "Completion",
           "Request", "RequestFailedError", "RequestHandle", "RequestState",
           "ServingError", "ShedError", "Health", "shed_handle",
           "SpecConfig", "SpecDecoder", "dequant_params", "prepare_params",
           "quantize_params"]
