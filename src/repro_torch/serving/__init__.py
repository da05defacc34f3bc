"""Fleet-backed decode serving in the port: paged KV cache on the device,
continuous batching, projection GEMMs on the device fleet, request-level
latency accounting.

Entry point: :meth:`repro_torch.api.TorchCleaveRuntime.serve_session`.
"""
from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.serving.decode_session import (ServeReport, ServeSession,
                                                ServeStepReport)
from repro_torch.serving.kv_cache import CacheStats, PagedKVCache, quantize_kv
from repro_torch.serving.loadgen import generate_requests, run_load

__all__ = [
    "ContinuousBatcher", "Request", "ServeReport", "ServeSession",
    "ServeStepReport", "CacheStats", "PagedKVCache", "quantize_kv",
    "generate_requests", "run_load",
]
