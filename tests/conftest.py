import json
import os

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# chaos-failure forensics (DESIGN.md §14)
#
# Chaos tests register their runtimes through the ``chaos_forensics``
# fixture; when such a test fails, the makereport hook dumps the seed,
# the armed fault/netfault schedules, and the tail of the telemetry
# stream to ``.pytest_artifacts/<test>.json`` so the exact run can be
# replayed without re-deriving the drawn timeline from the seed.
# ---------------------------------------------------------------------------

_ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), os.pardir,
                             ".pytest_artifacts")
_FORENSICS_TAIL = 80
_registry = {}   # nodeid -> list of registered runtimes


@pytest.fixture
def chaos_forensics(request):
    """Call the yielded function on every ClusterRuntime the test
    builds; on failure their fault state is dumped as an artifact."""
    rts = _registry.setdefault(request.node.nodeid, [])

    def register(rt):
        rts.append(rt)
        return rt

    yield register
    _registry.pop(request.node.nodeid, None)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return repr(v)


def _forensics(rt):
    out = {
        "seed": getattr(rt, "seed", None),
        "n_workers": getattr(rt, "w", None),
        "n_ps": getattr(rt, "n_ps", None),
        "policy": type(getattr(rt, "policy", None)).__name__,
        "transport": getattr(rt, "transport", None),
        "sim_now": getattr(getattr(rt, "sim", None), "now", None),
    }
    faults = getattr(rt, "faults", None)
    if faults is not None:
        out["faults"] = [e.label() for e in faults]
    net_faults = getattr(rt, "net_faults", None)
    if net_faults is not None:
        out["net_faults"] = [e.label() for e in net_faults]
    tel = getattr(rt, "tel", None)
    if tel is not None and tel.events:
        out["n_events"] = len(tel.events)
        out["events_tail"] = _jsonable(tel.events[-_FORENSICS_TAIL:])
    return out


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    outcome = yield
    report = outcome.get_result()
    if report.when != "call" or not report.failed:
        return
    rts = _registry.get(item.nodeid)
    if not rts:
        return
    os.makedirs(_ARTIFACT_DIR, exist_ok=True)
    safe = item.nodeid.replace("/", "_").replace("::", "-")
    path = os.path.join(_ARTIFACT_DIR, f"{safe}.json")
    try:
        with open(path, "w") as f:
            json.dump({"test": item.nodeid,
                       "runs": [_forensics(rt) for rt in rts]}, f,
                      indent=1, default=repr)
        report.sections.append(
            ("chaos forensics", f"fault-state dump written to {path}"))
    except Exception as exc:   # a broken dump must not mask the failure
        report.sections.append(
            ("chaos forensics", f"dump failed: {exc!r}"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")
