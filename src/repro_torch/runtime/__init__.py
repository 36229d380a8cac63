"""Event-driven cluster runtime: compute/network co-simulation with
pluggable PS aggregation policies (DESIGN.md §8), the network fault
plane and the loss-budget controller (DESIGN.md §14), and the step
machinery of the PS training loop (``step.py``)."""
from repro_torch.runtime.compute import (  # noqa: F401
    COMPUTE_MODELS,
    ComputeModel,
    DeterministicCompute,
    LognormalStragglerCompute,
    TraceCompute,
    make_compute_model,
)
from repro_torch.net.netfaults import (  # noqa: F401
    LINK_FAULT_KINDS,
    LinkFaultEvent,
    LinkFaultSchedule,
    NetFaultPlane,
    netfault_schedule_from_config,
)
from repro_torch.runtime.budget import BudgetController  # noqa: F401
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
