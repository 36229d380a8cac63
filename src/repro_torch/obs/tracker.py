"""Pluggable ``Tracker`` backends (DESIGN.md §12).

A ``Tracker`` is the one-way sink the runtime's observability layer
emits into — the levanter-style split between *producing* telemetry
(``runtime.telemetry.Telemetry``, the metrics registry) and *shipping*
it somewhere a human or dashboard can read it. The contract is
deliberately narrow so a backend is ~30 lines:

  ``log_event(event)``      one structured runtime event (the §8 schema:
                            ``kind``, ``t``, payload fields). Called on
                            the DES hot path — implementations MUST be
                            O(1) per call (append to a buffer; never
                            serialize, flush, or walk state inline).
  ``log_metrics(m, step=)`` a dict of scalar series points (loss, bst,
                            delivered ... per training step).
  ``log_summary(m)``        end-of-run scalars (``Telemetry.summary()``
                            plus the metrics-registry snapshot).
  ``finish()``              serialize + release resources. The runtime
                            calls it once, AFTER the event loop drained
                            and lazy device scalars were forced — the only
                            point where file I/O is allowed to block.

Backends: ``MemoryTracker`` (lists, for tests/notebooks),
``JsonlTracker`` (one JSON object per line), ``CsvTracker``
(union-of-keys header, written at finish), ``CompositeTracker``
(fan-out), ``TensorBoardTracker`` (optional — raises a clear error
when no tensorboard writer package is installed), and ``NullTracker``
(explicit no-op). ``make_tracker`` builds any of them from an
``ObservabilityConfig``; ``tracker="none"`` resolves to ``None`` so
the hot path keeps a single ``is not None`` branch and nothing else.
"""
from __future__ import annotations

import abc
import csv
import io
import json
import os
from typing import TYPE_CHECKING, Any, Dict, List, Mapping, Optional, Sequence

if TYPE_CHECKING:
    from repro_torch.config import ObservabilityConfig

#: backend names ``make_tracker`` accepts (comma-compose for fan-out).
TRACKER_BACKENDS = ("none", "memory", "jsonl", "csv", "tensorboard")


def _json_default(v: Any) -> Any:
    """Last-resort encoder for event payloads: numpy scalars and 0-d tensors become
    floats, everything else a string — serialization must never throw
    after a run completed."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class Tracker(abc.ABC):
    """Abstract telemetry sink; see the module docstring for the
    contract. Context-manager use guarantees ``finish``."""

    name: str = "abstract"

    @abc.abstractmethod
    def log_event(self, event: Mapping[str, Any]) -> None:
        """Record one structured runtime event (O(1), hot path)."""

    @abc.abstractmethod
    def log_metrics(self, metrics: Mapping[str, Any], *,
                    step: Optional[int] = None) -> None:
        """Record a point of per-step scalar series."""

    @abc.abstractmethod
    def log_summary(self, metrics: Mapping[str, Any]) -> None:
        """Record end-of-run scalars."""

    def finish(self) -> None:
        """Flush/close. Idempotent; the only call allowed to block."""

    def __enter__(self) -> "Tracker":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.finish()


class NullTracker(Tracker):
    """Explicit no-op sink (API completeness; the runtime maps
    ``tracker='none'`` to ``None`` instead so the hot path pays a single
    branch, not a virtual call)."""

    name = "none"

    def log_event(self, event: Mapping[str, Any]) -> None:
        pass

    def log_metrics(self, metrics: Mapping[str, Any], *,
                    step: Optional[int] = None) -> None:
        pass

    def log_summary(self, metrics: Mapping[str, Any]) -> None:
        pass


class MemoryTracker(Tracker):
    """Keep everything in lists — tests and notebooks."""

    name = "memory"

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []
        self.metrics: List[Dict[str, Any]] = []
        self.summary: Dict[str, Any] = {}
        self.finished = False

    def log_event(self, event: Mapping[str, Any]) -> None:
        self.events.append(dict(event))

    def log_metrics(self, metrics: Mapping[str, Any], *,
                    step: Optional[int] = None) -> None:
        row = dict(metrics)
        if step is not None:
            row["step"] = step
        self.metrics.append(row)

    def log_summary(self, metrics: Mapping[str, Any]) -> None:
        self.summary.update(metrics)

    def finish(self) -> None:
        self.finished = True


class _BufferedFileTracker(Tracker):
    """Shared buffering discipline for the file backends: ``log_*`` is
    an O(1) append; serialization happens in ``finish`` (or an explicit
    ``flush``), after the runtime forced its lazy device scalars — a
    mid-run flush would both block the event loop and serialize
    unforced device values (DESIGN.md §9/§12)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._events: List[Mapping[str, Any]] = []
        self._metrics: List[Dict[str, Any]] = []
        self._summary: Dict[str, Any] = {}
        self._finished = False

    def log_event(self, event: Mapping[str, Any]) -> None:
        self._events.append(event)

    def log_metrics(self, metrics: Mapping[str, Any], *,
                    step: Optional[int] = None) -> None:
        row = dict(metrics)
        if step is not None:
            row["step"] = step
        self._metrics.append(row)

    def log_summary(self, metrics: Mapping[str, Any]) -> None:
        self._summary.update(metrics)

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        self._write()

    def _write(self) -> None:
        raise NotImplementedError


class JsonlTracker(_BufferedFileTracker):
    """One JSON object per line: events as-is (``{"kind": ..., "t": ...,
    ...}``), metric points as ``{"kind": "metrics", ...}``, the summary
    as one ``{"kind": "summary", ...}`` tail record."""

    name = "jsonl"

    def _write(self) -> None:
        with open(self.path, "w") as f:
            for e in self._events:
                f.write(json.dumps(e, default=_json_default) + "\n")
            for m in self._metrics:
                f.write(json.dumps({"kind": "metrics", **m},
                                   default=_json_default) + "\n")
            if self._summary:
                f.write(json.dumps({"kind": "summary", **self._summary},
                                   default=_json_default) + "\n")


class CsvTracker(_BufferedFileTracker):
    """Events as one CSV with the union-of-keys header (the §8 event
    kinds carry different payloads; absent fields are empty cells). The
    summary lands next to it as ``<path>.summary.json``."""

    name = "csv"

    def _write(self) -> None:
        keys: List[str] = []
        seen = set()
        for e in list(self._events) + self._metrics:
            for k in e:
                if k not in seen:
                    seen.add(k)
                    keys.append(k)
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys, restval="")
            w.writeheader()
            for e in self._events:
                w.writerow({k: e.get(k, "") for k in keys})
            for m in self._metrics:
                w.writerow({k: m.get(k, "") for k in keys})
        if self._summary:
            with open(self.path + ".summary.json", "w") as f:
                json.dump(self._summary, f, indent=1,
                          default=_json_default)


class CompositeTracker(Tracker):
    """Fan every call out to child trackers in order."""

    name = "composite"

    def __init__(self, children: Sequence[Tracker]) -> None:
        self.children = list(children)

    def log_event(self, event: Mapping[str, Any]) -> None:
        for c in self.children:
            c.log_event(event)

    def log_metrics(self, metrics: Mapping[str, Any], *,
                    step: Optional[int] = None) -> None:
        for c in self.children:
            c.log_metrics(metrics, step=step)

    def log_summary(self, metrics: Mapping[str, Any]) -> None:
        for c in self.children:
            c.log_summary(metrics)

    def finish(self) -> None:
        for c in self.children:
            c.finish()


class TensorBoardTracker(Tracker):
    """Scalar series into a TensorBoard event file. Optional: imports
    ``tensorboardX`` or ``torch.utils.tensorboard`` lazily and raises
    an actionable ``ImportError`` when neither is installed (the
    container does not bake one in; tests importorskip)."""

    name = "tensorboard"

    def __init__(self, log_dir: str) -> None:
        writer_cls = None
        for mod, attr in (("tensorboardX", "SummaryWriter"),
                          ("torch.utils.tensorboard", "SummaryWriter")):
            try:
                writer_cls = getattr(__import__(mod, fromlist=[attr]), attr)
                break
            except ImportError:
                continue
        if writer_cls is None:
            raise ImportError(
                "TensorBoardTracker needs tensorboardX or torch installed; "
                "use tracker='jsonl' (or 'csv') on this machine")
        self._writer = writer_cls(log_dir=log_dir)
        self._n_events = 0

    def log_event(self, event: Mapping[str, Any]) -> None:
        self._n_events += 1  # event streams don't map to TB scalars

    def log_metrics(self, metrics: Mapping[str, Any], *,
                    step: Optional[int] = None) -> None:
        step = 0 if step is None else int(step)
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self._writer.add_scalar(k, v, global_step=step)

    def log_summary(self, metrics: Mapping[str, Any]) -> None:
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self._writer.add_scalar(f"summary/{k}", v, global_step=0)

    def finish(self) -> None:
        self._writer.close()


def make_tracker(cfg: "ObservabilityConfig",
                 run_name: str = "run") -> Optional[Tracker]:
    """Build the tracker an ``ObservabilityConfig`` selects.

    ``cfg.tracker`` is a backend name or a comma-separated list (the
    composite). ``"none"``/empty resolves to ``None`` — the runtime's
    zero-overhead path. File backends write to ``cfg.path`` when given,
    else ``<cfg.out_dir>/<run_name>.<ext>``.
    """
    names = [n.strip() for n in (cfg.tracker or "none").split(",")
             if n.strip() and n.strip() != "none"]
    if not names:
        return None

    def one(name: str) -> Tracker:
        if name == "memory":
            return MemoryTracker()
        if name == "jsonl":
            return JsonlTracker(
                cfg.path or os.path.join(cfg.out_dir, f"{run_name}.jsonl"))
        if name == "csv":
            return CsvTracker(
                cfg.path or os.path.join(cfg.out_dir, f"{run_name}.csv"))
        if name == "tensorboard":
            return TensorBoardTracker(os.path.join(cfg.out_dir, run_name))
        raise ValueError(f"unknown tracker backend {name!r}; expected one "
                         f"of {TRACKER_BACKENDS} (comma-compose for "
                         f"fan-out)")

    if len(names) == 1:
        return one(names[0])
    return CompositeTracker([one(n) for n in names])


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a ``JsonlTracker`` file back into a list of dicts (tests,
    ad-hoc analysis)."""
    out: List[Dict[str, Any]] = []
    with io.open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
