"""Serving: the token engine and the design-serving tier.

The design tier: :class:`DesignService` and :class:`BatchingDesignService`
over the ``Session`` façade, the resilience stack (fault taxonomy, retry,
deadlines, circuit breaker), the seeded chaos harness, the batching
mechanics and the persistent program cache (``Session(cache_dir=...)``);
above them the staged, pooled (threads) and multi-process services
(:mod:`repro_torch.serving.pool`) and their frame protocol.
"""
from repro_torch.serving.aotcache import AotCache, CacheCorruption, cache_key_digest  # noqa: F401
from repro_torch.serving.batching import FlushPolicy, IntakeQueue  # noqa: F401
from repro_torch.serving.chaos import ChaosConfig, ChaosInjector, FaultPlan  # noqa: F401
from repro_torch.serving.engine import (  # noqa: F401
    BatchingDesignService,
    DesignQuery,
    DesignReply,
    DesignService,
    Engine,
    Request,
    ServiceStats,
)
from repro_torch.serving.pool import (  # noqa: F401
    MultiProcessDesignService,
    PooledDesignService,
    StagedBatchingService,
)
from repro_torch.serving.protocol import ProtocolError, recv_frame, send_frame  # noqa: F401
from repro_torch.serving.resilience import (  # noqa: F401
    CircuitBreaker,
    CircuitOpen,
    ClientError,
    DeadlineConfig,
    DeadlineExceeded,
    FaultInfo,
    NumericFault,
    RetryPolicy,
    ServingFault,
    TransientFault,
    classify_exception,
    nonfinite_in,
    run_guarded,
)
