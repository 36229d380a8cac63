"""Sanctioned accessors for the flow-generation fence (DESIGN.md §9.2).

Pooled flows are reused across iterations; each life bumps the flow's
generation, the sender stamps it into every outgoing packet's meta, the
receiver echoes it in ACKs, and stops carry it too. Any packet or echo
whose generation differs from the current one belongs to a previous
life and MUST be dropped — PR 5's fence gaps (and the replint
``gen-fence`` rule that now mechanizes them, DESIGN.md §13) exist
because three hand-rolled copies of this compare drifted apart.

Every read/write of the generation key goes through this module:

* write sites put ``GEN_KEY`` in the meta dict literal
  (``meta={"t": now, GEN_KEY: self.gen}``) — a name load, so the
  per-packet hot path pays nothing over the raw string;
* read sites call :func:`is_stale` (packet metas), :func:`echo_stale`
  (ACK echo dicts), or :func:`gen_of` (raw extraction).

The module is import-light on purpose: senders, receivers, and the
runtime transport all pull it into per-packet code.
"""
from __future__ import annotations

from typing import Any, Optional

#: the meta key carrying a pooled flow's generation
GEN_KEY = "g"


def gen_of(meta: Any, default: Optional[int] = None) -> Optional[int]:
    """The generation stamped in ``meta``, or ``default`` when the meta
    is not a dict or carries no generation (unpooled traffic)."""
    if isinstance(meta, dict):
        return meta.get(GEN_KEY, default)
    return default


def has_gen(meta: Any) -> bool:
    """True when ``meta`` carries a generation stamp."""
    return isinstance(meta, dict) and GEN_KEY in meta


def is_stale(meta: Any, gen: int) -> bool:
    """True when ``meta`` was stamped by a previous life of a pooled
    flow. Unstamped traffic (no meta / no key) is *current*: only an
    explicit mismatching stamp fences a packet."""
    return isinstance(meta, dict) and meta.get(GEN_KEY, gen) != gen


def echo_stale(echo: Any, gen: int) -> bool:
    """:func:`is_stale` over an ACK's echoed request meta. Split out so
    ACK-path call sites read as what they check, and so the two shapes
    can diverge later without touching callers."""
    return isinstance(echo, dict) and echo.get(GEN_KEY, gen) != gen
