"""Packet-level discrete-event transport simulator: the port's numpy-only
copy of the JAX package's ``net/``.

Reproduces the paper's protocol-level experiments at packet granularity:
Fig 3 (incast FCT long tail), Fig 4 (TCP under non-congestion loss),
Fig 12/14 (training throughput / BST), Fig 15 (fairness) — plus the
composable topology engine behind the multi-PS / straggler / cross-traffic
scenarios (DESIGN.md §5). Run any scenario by name via ``run_scenario``.
The network fault plane is ``netfaults`` (DESIGN.md §14); the runtime
package re-exports it.
"""
from repro_torch.net.simcore import (  # noqa: F401
    CrossTrafficSource,
    Packet,
    Pipe,
    Route,
    Sim,
    Topology,
)
from repro_torch.net.aggtree import AggIngress, AggSwitch  # noqa: F401
from repro_torch.net.scenarios import (  # noqa: F401
    PROTOCOLS,
    SCENARIOS,
    GatherSpec,
    cross_traffic,
    fairness_share,
    incast_gather,
    list_scenarios,
    multi_ps_gather,
    p2p_transfer,
    rack_spine_gather,
    run_scenario,
    straggler_gather,
    topology_gather,
    train_iterations,
)
# topology-first builders (DESIGN.md §11). The builder result class
# (repro_torch.net.topology.Topology) is NOT re-exported by name here — it
# would shadow the simcore pipe registry above; use the builders.
from repro_torch.net.topology import (  # noqa: F401
    APIDeprecationWarning,
    as_topology,
    flat,
    multi_ps,
    rack_spine,
    resolve_topology,
)
