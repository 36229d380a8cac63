"""Event-driven cluster runtime: compute/network co-simulation with
pluggable PS aggregation policies (DESIGN.md §8), and the step
machinery of the PS training loop (``step.py``). Network faults and the
loss-budget controller come with their port (ROADMAP.md, queue 1 item
8b(ii))."""
from repro_torch.runtime.compute import (  # noqa: F401
    COMPUTE_MODELS,
    ComputeModel,
    DeterministicCompute,
    LognormalStragglerCompute,
    TraceCompute,
    make_compute_model,
)
from repro_torch.runtime.faults import (  # noqa: F401
    FAULT_KINDS,
    FaultEvent,
    FaultSchedule,
    ShardLedger,
    schedule_from_config,
)
from repro_torch.runtime.policies import (  # noqa: F401
    POLICIES,
    AggregationPolicy,
    AsyncPolicy,
    BSPPolicy,
    PendingGrad,
    SSPPolicy,
    make_policy,
)
from repro_torch.runtime.runtime import ClusterRuntime  # noqa: F401
from repro_torch.runtime.telemetry import Telemetry  # noqa: F401
from repro_torch.runtime.transport import (  # noqa: F401
    AnalyticPerWorkerNet,
    DESTransport,
)
