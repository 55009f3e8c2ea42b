"""Paged continuous-batching serving for the port: the resource controller
with tenant policies and SLO shed, reserve-full admission, chunked prefill,
H-step greedy megasteps, fp or int8 KV pools, the copy-on-write
shared-prefix cache, ``ServingMetrics``, the span tracer and the fault
plane."""
from .controller import Observation, PlanAction, ResourceController, TargetState
from .engine import EngineConfig, PagedServingEngine, quantized_greedy_reference
from .faults import (
    DeadlineExceeded,
    ExpertUploadFailed,
    FaultPlan,
    FaultSpec,
    InvalidRequest,
    LivelockDetected,
    PoisonedRequest,
    RequestCancelled,
    ServingFault,
    SwapFault,
    WatchdogTimeout,
    checksum_tree,
)
from .kvcache import BlockAllocator, PagedKVCache, PoolExhausted, PrefixCache, PrefixEntry
from .metrics import ServingMetrics
from .scheduler import VALID_POLICIES, Request, Scheduler
from .trace import (
    ExpertRoutingTelemetry,
    MetricsConsumer,
    SpanTracer,
    validate_chrome_trace,
    validate_events,
)

__all__ = [
    "BlockAllocator", "DeadlineExceeded", "EngineConfig", "ExpertRoutingTelemetry",
    "ExpertUploadFailed", "FaultPlan", "FaultSpec", "InvalidRequest", "LivelockDetected",
    "MetricsConsumer", "Observation", "PagedKVCache", "PagedServingEngine", "PlanAction",
    "PoisonedRequest", "PoolExhausted", "PrefixCache", "PrefixEntry", "Request",
    "RequestCancelled", "ResourceController", "Scheduler", "ServingFault", "ServingMetrics",
    "SpanTracer", "SwapFault", "TargetState", "VALID_POLICIES", "WatchdogTimeout",
    "checksum_tree", "quantized_greedy_reference", "validate_chrome_trace", "validate_events",
]
