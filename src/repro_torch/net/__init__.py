"""Network-side pieces of the port. Only the topology builders are here
so far; the packet-level simulator stays in the JAX package until its
port (ROADMAP.md, queue 1 item 8)."""
from repro_torch.net.topology import (  # noqa: F401
    APIDeprecationWarning,
    GatherSpec,
    Topology,
    flat,
    multi_ps,
    rack_spine,
    resolve_topology,
)
