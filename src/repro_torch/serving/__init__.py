from repro_torch.serving.engine import (Engine, EngineConfig, Request,
                                        RequestResult, resolve_use_kernel)
from repro_torch.serving.evaluate import (EvalResult, evaluate_method,
                                          evaluate_method_batched,
                                          make_problems, poisson_arrivals)
from repro_torch.serving.faults import (DeviceStepFault, FatalFaultError,
                                        FaultPlan, FaultSpec, FaultStats,
                                        RecoveryConfig)
from repro_torch.serving.kv_manager import BlockManager, Reservation
from repro_torch.serving.metrics import (RequestMetrics, percentiles,
                                         summarize, summarize_by_tenant)
from repro_torch.serving.prefix_cache import CacheStats, PrefixCache
from repro_torch.serving.queue import RequestQueue
from repro_torch.serving.sampling import (SamplingParams, sample_tokens,
                                          sample_tokens_lanes)
from repro_torch.serving.scheduler import (SLO, Arrival, BudgetReplenish,
                                           BurstDone, Cancelled, ChunkDone,
                                           Completion,
                                           DeficitRoundRobin, Event,
                                           FIFOPolicy, SchedulerCore,
                                           SchedulingPolicy, TenantScheduler,
                                           TokenBudget, WeightedTokenBudget,
                                           default_scheduler,
                                           parse_tenant_weights)

__all__ = [
    "Engine", "EngineConfig", "Request", "RequestResult",
    "resolve_use_kernel",
    "EvalResult", "evaluate_method", "evaluate_method_batched",
    "make_problems", "poisson_arrivals",
    "BlockManager", "Reservation", "RequestQueue",
    "PrefixCache", "CacheStats",
    "RequestMetrics", "percentiles", "summarize", "summarize_by_tenant",
    "SamplingParams", "sample_tokens", "sample_tokens_lanes",
    "SLO", "SchedulerCore", "SchedulingPolicy", "FIFOPolicy",
    "TenantScheduler", "DeficitRoundRobin", "TokenBudget",
    "WeightedTokenBudget", "default_scheduler", "parse_tenant_weights",
    "Event", "Arrival", "BudgetReplenish", "ChunkDone", "BurstDone",
    "Completion", "Cancelled",
    "FaultPlan", "FaultSpec", "FaultStats", "RecoveryConfig",
    "DeviceStepFault", "FatalFaultError",
]
