"""Network-side pieces of the port: the topology builders, and the
discrete-event core (``simcore``) whose ``Sim`` clock drives the cluster
runtime. The packet-level simulator's senders, receivers and scenarios
come with their port (ROADMAP.md, queue 1 item 8b)."""
from repro_torch.net.topology import (  # noqa: F401
    APIDeprecationWarning,
    GatherSpec,
    Topology,
    flat,
    multi_ps,
    rack_spine,
    resolve_topology,
)
