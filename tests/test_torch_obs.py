"""The port's observability layer (repro_torch.obs, on the CPU) against
the JAX package's, as tests/test_obs.py sets it up: the Tracker
backends, the metrics registry, Chrome-trace export and validation of a
faulted runtime run (analytic transport), and the tracker="none"
bitwise-parity guarantee."""
import csv
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.config import LTPConfig as JLTPConfig
from repro.config import NetConfig as JNetConfig
from repro.config import ObservabilityConfig as JObservabilityConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.data import SyntheticCIFAR as JSyntheticCIFAR
from repro.data import batches as jbatches
from repro.models import build as jbuild
from repro.obs.metrics import Histogram as JHistogram
from repro.obs.trace import chrome_trace as jchrome_trace
from repro.obs.trace import validate_chrome_trace as jvalidate
from repro.optim import make_optimizer as jmake_optimizer
import repro.runtime as jrun
from repro_torch.config import (
    LTPConfig,
    NetConfig,
    ObservabilityConfig,
    TrainConfig,
)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import SyntheticCIFAR, batches
from repro_torch.models import build
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.tracker import (
    CompositeTracker,
    CsvTracker,
    JsonlTracker,
    MemoryTracker,
    TensorBoardTracker,
    make_tracker,
    read_jsonl,
)
from repro_torch.obs.trace import chrome_trace, validate_chrome_trace
from repro_torch.optim import make_optimizer
import repro_torch.runtime as trun

W = 4
STEPS = 6
NET = (10, 1, 0.001, 4096)
SMALL = dict(d_model=8, n_layers=3)


def _faults(R):
    return R.FaultSchedule([
        R.FaultEvent(0.08, "worker_crash", W - 1),
        R.FaultEvent(0.30, "ps_fail", 0, recover_s=0.02),
        R.FaultEvent(0.60, "worker_join", W - 1),
    ])


def _runtime_kw(R, faults):
    kw = dict(n_workers=W, policy="bsp", transport="analytic",
              compute_model=R.LognormalStragglerCompute(
                  W, base=0.05, seed=11, sigma=0.3, straggler_prob=0.15,
                  straggler_mult=5.0),
              seed=11)
    if faults:
        kw.update(faults=_faults(R), checkpoint_every_s=0.1)
    return kw


def _jax_rt(obs=None, faults=True):
    japi = jbuild(jget_config("papernet").replace(**SMALL))
    jtc = JTrainConfig(batch=4 * W, lr=0.05, steps=STEPS)
    return jrun.ClusterRuntime(
        japi, jmake_optimizer(jtc), jtc, JLTPConfig(staleness_comp=0.5),
        JNetConfig(*NET), obs=obs, **_runtime_kw(jrun, faults))


def _port_rt(init, obs=None, faults=True):
    tc = TrainConfig(batch=4 * W, lr=0.05, steps=STEPS)
    return trun.ClusterRuntime(
        build(get_config("papernet").replace(**SMALL)), make_optimizer(tc),
        tc, LTPConfig(staleness_comp=0.5), NetConfig(*NET), obs=obs,
        device="cpu", params=params_from_numpy(init, "cpu"),
        **_runtime_kw(trun, faults))


def _run(rt, data):
    rt.run(data(seed=3)(4 * W, STEPS))
    return rt


def _jdata(seed):
    return lambda b, n: jbatches(JSyntheticCIFAR(seed=seed), b, n)


def _tdata(seed):
    return lambda b, n: batches(SyntheticCIFAR(seed=seed), b, n)


def _strip_loss(events):
    return [{k: v for k, v in e.items() if k != "loss"} for e in events]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these runs launch many small ops, which
    several test processes sharing the cores slow down many times over
    when each op spreads over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def runs():
    """The faulted run, tracker="memory", once in each package from the
    same params."""
    jrt = _jax_rt(obs=JObservabilityConfig(tracker="memory"))
    init = jax.tree.map(np.asarray, jrt.params)
    _run(jrt, _jdata)
    rt = _run(_port_rt(init, obs=ObservabilityConfig(tracker="memory")),
              _tdata)
    return init, rt, jrt


# ---------------------------------------------------------------------------
# tracker backends
# ---------------------------------------------------------------------------


def test_memory_tracker_captures_and_finishes():
    t = MemoryTracker()
    t.log_event({"kind": "apply", "t": 0.1, "step": 0})
    t.log_metrics({"loss": 1.5}, step=0)
    t.log_summary({"steps": 1})
    t.finish()
    assert t.events[0]["kind"] == "apply"
    assert t.metrics[0]["loss"] == 1.5 and t.metrics[0]["step"] == 0
    assert t.summary == {"steps": 1}
    assert t.finished


def test_jsonl_tracker_round_trip(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with JsonlTracker(path) as t:
        t.log_event({"kind": "apply", "t": 0.1, "step": 0})
        t.log_metrics({"loss": 1.5}, step=0)
        t.log_summary({"steps": 1})
    recs = read_jsonl(path)
    assert [r.get("kind") for r in recs] == ["apply", "metrics", "summary"]
    assert recs[1]["loss"] == 1.5
    assert recs[2]["steps"] == 1


def test_jsonl_tracker_buffers_until_finish(tmp_path):
    # lazy-scalar contract: nothing hits disk before finish(), so device
    # scalars finalized in place after the run serialize as floats
    path = str(tmp_path / "lazy.jsonl")
    t = JsonlTracker(path)
    e = {"kind": "apply", "t": 0.1, "loss": None}
    t.log_event(e)
    assert not os.path.exists(path) or os.path.getsize(path) == 0
    e["loss"] = 2.5          # mutate the buffered dict, as the runtime does
    t.finish()
    assert read_jsonl(path)[0]["loss"] == 2.5


def test_jsonl_tracker_serializes_a_tensor_as_a_float(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with JsonlTracker(path) as t:
        t.log_event({"kind": "apply", "t": 0.1,
                     "loss": torch.tensor(1.25)})
    assert read_jsonl(path)[0]["loss"] == 1.25


def test_csv_tracker_union_header_and_summary(tmp_path):
    path = str(tmp_path / "run.csv")
    with CsvTracker(path) as t:
        t.log_event({"kind": "apply", "t": 0.1, "step": 0})
        t.log_event({"kind": "block", "t": 0.2, "worker": 1})
        t.log_summary({"steps": 1})
    with open(path) as f:
        rows = list(csv.DictReader(f))
    # union-of-keys header: every record exposes every column
    assert {"kind", "t", "step", "worker"} <= set(rows[0].keys())
    assert rows[0]["kind"] == "apply" and rows[1]["worker"] == "1"
    with open(path + ".summary.json") as f:
        assert json.load(f) == {"steps": 1}


def test_composite_fans_out():
    a, b = MemoryTracker(), MemoryTracker()
    c = CompositeTracker([a, b])
    c.log_event({"kind": "apply", "t": 0.0})
    c.finish()
    assert len(a.events) == len(b.events) == 1
    assert a.finished and b.finished


def test_make_tracker_none_and_unknown(tmp_path):
    assert make_tracker(ObservabilityConfig(tracker="none"), "r") is None
    assert make_tracker(ObservabilityConfig(tracker=""), "r") is None
    with pytest.raises(ValueError, match="unknown tracker"):
        make_tracker(ObservabilityConfig(tracker="bogus"), "r")
    t = make_tracker(ObservabilityConfig(
        tracker="memory,jsonl", out_dir=str(tmp_path)), "myrun")
    assert isinstance(t, CompositeTracker)
    t.finish()
    assert os.path.exists(str(tmp_path / "myrun.jsonl"))


def test_tensorboard_tracker_stays_optional(monkeypatch, tmp_path):
    """Without tensorboardX or torch's tensorboard writer the backend
    raises an actionable ImportError, and nothing else imports it."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="tracker='jsonl'"):
        TensorBoardTracker(str(tmp_path))
    with pytest.raises(ImportError, match="tensorboardX or torch"):
        make_tracker(ObservabilityConfig(tracker="tensorboard",
                                         out_dir=str(tmp_path)), "r")


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_counter_and_gauge():
    c = Counter("n")
    c.inc()
    c.inc(4)
    assert c.value == 5
    g = Gauge("g")
    g.set(2.5)
    assert g.value == 2.5


def test_histogram_exact_stats_and_the_jax_reservoir():
    h = Histogram("h", reservoir=8, seed=0)
    jh = JHistogram("h", reservoir=8, seed=0)
    for v in range(100):
        h.observe(float(v))
        jh.observe(float(v))
    snap = h.snapshot()
    # exact regardless of reservoir size
    assert snap["count"] == 100
    assert snap["min"] == 0.0 and snap["max"] == 99.0
    assert snap["mean"] == pytest.approx(49.5)
    # percentiles from the same seeded 8-sample reservoir
    assert snap == jh.snapshot()


def test_registry_absorb_and_snapshot():
    reg = MetricsRegistry(reservoir=16, seed=0)
    reg.counter("a").inc(3)
    reg.histogram("h").observe(1.0)
    reg.absorb("flow", {"n_retx": 2, "n_ack_trains": 10})
    reg.absorb("flow", {"n_retx": 5, "n_ack_trains": 11})  # cumulative SET
    snap = reg.snapshot()
    assert snap["a"] == 3
    assert snap["flow/n_retx"] == 5
    assert snap["flow/n_ack_trains"] == 11
    assert snap["h/count"] == 1
    # get-or-create returns the same instrument
    assert reg.counter("a") is reg.counter("a")


# ---------------------------------------------------------------------------
# chrome trace of a faulted run
# ---------------------------------------------------------------------------


def test_faulted_run_matches_jax(runs):
    """The faulted run's history and event stream are the JAX run's
    (loss within rtol 1e-4)."""
    _, rt, jrt = runs
    assert [{k: v for k, v in r.items() if k != "loss"}
            for r in rt.history] == \
        [{k: v for k, v in r.items() if k != "loss"} for r in jrt.history]
    np.testing.assert_allclose([r["loss"] for r in rt.history],
                               [r["loss"] for r in jrt.history], rtol=1e-4)
    assert _strip_loss(rt.tel.events) == _strip_loss(jrt.tel.events)


def test_faulted_trace_validates(runs, tmp_path):
    _, rt, _ = runs
    path = str(tmp_path / "trace.json")
    doc = rt.export_trace(path)
    with open(path) as f:
        loaded = json.load(f)          # the artifact itself must parse
    problems = validate_chrome_trace(loaded, n_workers=W, n_ps=rt.n_ps,
                                     require_fault_markers=True)
    assert problems == [], problems
    # and the JAX package's validator accepts it too
    assert jvalidate(loaded, n_workers=W, n_ps=rt.n_ps,
                     require_fault_markers=True) == []
    assert doc["traceEvents"]
    assert loaded["otherData"]["transport"] == "analytic"
    phs = {e["ph"] for e in loaded["traceEvents"]}
    assert {"X", "i", "M"} <= phs


def test_chrome_trace_is_the_jax_packages(runs):
    _, rt, jrt = runs
    events = _strip_loss(rt.tel.events)
    assert chrome_trace(events, n_workers=W, n_ps=rt.n_ps) == \
        jchrome_trace(events, n_workers=W, n_ps=rt.n_ps)


def test_trace_has_fault_and_failover_markers(runs):
    _, rt, _ = runs
    doc = chrome_trace(rt.tel.events, n_workers=W, n_ps=rt.n_ps)
    names = {e["name"] for e in doc["traceEvents"]}
    assert any(n.startswith("fault:") for n in names)
    assert "ps_failover" in names
    assert "checkpoint" in names


def test_trace_spans_non_negative_and_metadata_complete(runs):
    _, rt, _ = runs
    doc = chrome_trace(rt.tel.events, n_workers=W, n_ps=rt.n_ps)
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            assert e["dur"] >= 0, e
    thread_meta = [e for e in doc["traceEvents"]
                   if e["ph"] == "M" and e["name"] == "thread_name"]
    # a track per worker on both the worker and transport processes
    assert len([m for m in thread_meta if m["pid"] == 1]) >= W
    assert len([m for m in thread_meta if m["pid"] == 2]) >= W


def test_tracker_run_populates_metrics_and_summary(runs):
    _, rt, jrt = runs
    mem = rt.tracker
    assert mem.finished
    assert len(mem.events) == len(rt.tel.events)
    assert len(mem.metrics) == STEPS            # one per step
    s = mem.summary
    assert s["n_faults"] == 3 and s["n_failovers"] == 1
    # registry scalars rode along: sim perf and the compute histogram
    assert s["sim/events"] > 0 and "worker/compute_s/count" in s
    # the same event loop, event for event
    assert s == jrt.tracker.summary


# ---------------------------------------------------------------------------
# tracker="none" bitwise parity
# ---------------------------------------------------------------------------


def test_tracker_none_bitwise_parity(runs):
    init = runs[0]
    base = _run(_port_rt(init, obs=None, faults=False), _tdata)
    obs = _run(_port_rt(init, obs=ObservabilityConfig(tracker="memory"),
                        faults=False), _tdata)
    assert base.tracker is None
    assert base.history == obs.history
    assert base.tel.events == obs.tel.events
    assert base.tel.summary() == obs.tel.summary()
