"""The port's wall-clock spans and host counters: the
fused step's and the apply's ``record_function`` spans, each opened once
a step or once a chunk of workers and nested as the PS sync path runs;
``ClusterRuntime.host_metrics``' timed spans and copy counters, exact
over a run; and a run's history, events and tracker summary the same
with a profiler running as without one."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.config import (
    LTPConfig,
    NetConfig,
    ObservabilityConfig,
    TrainConfig,
)
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCIFAR, batches
from repro_torch.models import build
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.optim import make_optimizer
from repro_torch.runtime import ClusterRuntime
from repro_torch.runtime import step as stp
from repro_torch.train import PSTrainer
from repro_torch.tree import tree_leaves

W = 4
SMALL = dict(d_model=8, n_layers=3)
NET = (10, 1, 0.001, 4096)
# a 10 Mbit/s trunk: async flows Early-Close with partial masks
SLOW_NET = (0.01, 1, 0.001, 4096)
HOST_SPANS = ("draw_delivery_masks", "stage_inputs", "bsp_commit")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n, seed=0):
    return list(batches(SyntheticCIFAR(seed=seed), 32, n))


def _trainer(protocol="ltp", ef=False, steps=3):
    tc = TrainConfig(batch=32, lr=0.05, steps=steps)
    return PSTrainer(build(get_config("papernet").replace(**SMALL)),
                     make_optimizer(tc), tc,
                     LTPConfig(error_feedback=ef), NetConfig(*NET),
                     n_workers=W, protocol=protocol, seed=0, device="cpu")


def _runtime(obs=None, **kw):
    tc = TrainConfig(batch=32, lr=0.05, steps=3)
    return ClusterRuntime(
        build(get_config("papernet").replace(**SMALL)), make_optimizer(tc),
        tc, LTPConfig(error_feedback=True), NetConfig(*kw.pop("net", NET)),
        n_workers=W, seed=0, device="cpu", obs=obs, **kw)


def _spans(fn):
    """``fn()`` under ``torch.profiler``: its host spans and operations
    as (name, start, end), in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()), key=lambda s: s[1])


def _named(spans, name):
    return [(a, b) for n, a, b in spans if n == name]


def _inside(inner, outer):
    return [i for i in inner if any(a <= i[0] and i[1] <= b
                                     for a, b in outer)]


@pytest.mark.parametrize("protocol,ef", [("ltp", False), ("ltp", True),
                                         ("cubic", False)],
                         ids=["ltp", "ltp_ef", "cubic"])
def test_bsp_step_spans(monkeypatch, protocol, ef):
    """A bsp step opens each host span once, ``stage_inputs`` inside
    ``bsp_commit`` and the draw outside it; each chunk of workers opens
    ``worker_grads`` and ``flatten_into`` once; the PS sync path's spans
    open once a step, in ``PS_SYNC_SPANS``' order, inside the commit."""
    steps = 2
    tr = _trainer(protocol, ef, steps)
    # 3 workers a vmap: two chunks (3, then 1), as Whisper's 5 and 3
    monkeypatch.setattr(stp, "WORKER_CHUNK_FLOATS", 3 * tr.plan.n_floats)
    spans = _spans(lambda: tr.run(_data(steps)))
    commits = _named(spans, "bsp_commit")
    assert len(commits) == steps
    for name in HOST_SPANS:
        assert len(_named(spans, name)) == steps, name
    assert len(_inside(_named(spans, "stage_inputs"), commits)) == steps
    assert not _inside(_named(spans, "draw_delivery_masks"), commits)
    for name in ("worker_grads", "flatten_into"):
        assert len(_inside(_named(spans, name), commits)) == 2 * steps
    sync = ("reduce_packet_stream", "unflatten", "opt_update")
    for name in sync:
        assert len(_inside(_named(spans, name), commits)) == steps, name
    # worker_grads and the PS sync spans never nest in one another
    ps = [s for s in spans if s[0] in ("worker_grads",) + stp.PS_SYNC_SPANS]
    assert all(a[2] <= b[1] for a, b in zip(ps, ps[1:]))
    per_step = ["worker_grads", "flatten_into"] * 2 \
        + (["ef_gate"] if ef else []) + list(sync)
    assert [s[0] for s in ps] == per_step * steps


def test_apply_spans():
    """The async apply opens the PS sync path's spans once an apply
    inside ``apply_batch``, the EF gate of each admitted gradient before
    the reduction."""
    rt = _runtime(policy="async", net=SLOW_NET)
    spans = _spans(lambda: rt.run(_data(2)))
    applies = _named(spans, "apply_batch")
    assert len(applies) == len(rt.history) > 0
    for a, b in applies:
        names = [n for n, s, e in spans if a <= s and e <= b
                 and n in stp.PS_SYNC_SPANS]
        k = names.count("ef_gate")
        assert k >= 1
        assert names == ["ef_gate"] * k + ["reduce_packet_stream",
                                           "unflatten", "opt_update"]
    assert not _named(spans, "bsp_commit")


def test_host_metrics_count_spans_and_copies():
    """Over k bsp steps whose batches outnumber the device cache, each
    host span is called k times, the cache misses are counted, and the
    bytes copied are the misses' batches plus every step's masks and
    fractions, exactly."""
    tr = _trainer("ltp", ef=False)
    pool = _data(10)
    tr.run(pool[:3])
    # the second call restarts at iteration 0 and finds the first three
    # iterations' batches (the same batches) still on the device
    tr.run(pool)
    k, misses = 13, 3 + 7
    snap = tr.host_metrics.snapshot()
    assert tr.host_metrics is tr._rt.host_metrics
    for name in HOST_SPANS:
        assert snap[f"span/{name}/calls"] == k
        assert snap[f"span/{name}/ns"] > 0
    assert snap["span/stage_inputs/ns"] < snap["span/bsp_commit/ns"]
    assert snap["h2d/batch_misses"] == misses
    batch_bytes = sum(v.nbytes for v in pool[0].values())
    mask_bytes = W * tr.plan.n_packets * 4
    frac_bytes = W * 4
    assert snap["h2d/bytes"] == misses * batch_bytes \
        + k * (mask_bytes + frac_bytes)
    # wall-clock readings stay out of the simulated cluster's registry
    assert not any(key.startswith(("span/", "h2d/"))
                   for key in tr._rt.metrics.snapshot())


def test_span_counts_nested_calls():
    """Spans of two names nest, each counting its own calls and time, the
    outer's time holding the inner's; a span entered again after it
    closed counts again; one name binds one pair of counters."""
    reg = MetricsRegistry()
    outer, inner = reg.span("outer"), reg.span("inner")
    with outer:
        with inner:
            pass
    with inner:
        pass
    snap = reg.snapshot()
    assert snap["span/outer/calls"] == 1 and snap["span/inner/calls"] == 2
    assert snap["span/outer/ns"] > 0 and snap["span/inner/ns"] > 0
    assert reg.span("inner").ns is inner.ns


def test_profiler_changes_no_result():
    """history, the event stream and the tracker's summary are the same
    with a profiler running as without one."""
    def run():
        rt = _runtime(obs=ObservabilityConfig(tracker="memory"))
        rt.run(_data(3))
        return rt

    base = run()
    traced = []
    _spans(lambda: traced.append(run()))
    traced = traced[0]
    assert base.history == traced.history
    assert base.tel.events == traced.tel.events
    assert base.tracker.summary == traced.tracker.summary
    assert not any(key.startswith(("span/", "h2d/"))
                   for key in base.tracker.summary)
    assert base.host_metrics.snapshot()["span/bsp_commit/calls"] == 3
    for a, b in zip(tree_leaves(base.params), tree_leaves(traced.params)):
        assert torch.equal(a, b)
