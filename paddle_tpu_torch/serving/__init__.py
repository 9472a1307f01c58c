"""Paged-KV continuous-batching decode serving (the port of
paddle_tpu/serving/): the DecodeEngine with its captured window, the
radix prefix cache, speculative decoding, int8 weights, and the
fault-tolerant tier (replicas, failover, resurrection, drain)."""
from .request import (Completion, Request, RequestFailedError,
                      RequestHandle, RequestState, ServingError, ShedError)
from .cache import (BlockAllocator, CacheConfig, PagedKVCache,
                    RadixPrefixCache)
from .resilience import (Health, NoHealthyReplicaError, ServingFrontend,
                         shed_handle)
from .engine import DecodeEngine, EngineConfig
from .frontend import RoundRobinFrontend, replicated_engines
from .spec import SpecConfig, SpecDecoder
from .weights import dequant_params, prepare_params, quantize_params

__all__ = [
    "BlockAllocator", "CacheConfig", "Completion", "DecodeEngine",
    "EngineConfig", "Health", "NoHealthyReplicaError", "PagedKVCache",
    "RadixPrefixCache", "Request", "RequestFailedError", "RequestHandle",
    "RequestState",
    "RoundRobinFrontend", "ServingError", "ServingFrontend", "ShedError",
    "SpecConfig", "SpecDecoder", "replicated_engines",
    "shed_handle", "dequant_params", "prepare_params", "quantize_params",
]
