"""Paged continuous-batching serving for the port: the resource controller
with tenant policies and SLO shed, admission with on-demand page growth,
victim preemption and the host KV swap store, chunked prefill,
H-step greedy megasteps, fp or int8 KV pools, the copy-on-write
shared-prefix cache, host-offloaded PMQ expert buckets (miss replay, EMA
prefetch, async uploads, the disk → host → device tier store),
``ServingMetrics``, the span tracer and the fault plane."""
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
from .kvcache import (
    BlockAllocator,
    PagedKVCache,
    PoolExhausted,
    PrefixCache,
    PrefixEntry,
    SwappedKV,
)
from .metrics import ServingMetrics
from .offload import ExpertOffloadManager, degrade_expert_row
from .scheduler import VALID_POLICIES, Request, Scheduler
from .tierstore import TieredExpertStore
from .trace import (
    ExpertRoutingTelemetry,
    MetricsConsumer,
    SpanTracer,
    validate_chrome_trace,
    validate_events,
)

__all__ = [
    "BlockAllocator", "DeadlineExceeded", "EngineConfig", "ExpertOffloadManager",
    "ExpertRoutingTelemetry", "ExpertUploadFailed", "FaultPlan", "FaultSpec", "InvalidRequest",
    "LivelockDetected", "MetricsConsumer", "Observation", "PagedKVCache", "PagedServingEngine",
    "PlanAction", "PoisonedRequest", "PoolExhausted", "PrefixCache", "PrefixEntry", "Request",
    "RequestCancelled", "ResourceController", "Scheduler", "ServingFault", "ServingMetrics",
    "SpanTracer", "SwapFault", "SwappedKV", "TargetState", "TieredExpertStore", "VALID_POLICIES",
    "WatchdogTimeout", "checksum_tree", "degrade_expert_row", "quantized_greedy_reference",
    "validate_chrome_trace", "validate_events",
]
