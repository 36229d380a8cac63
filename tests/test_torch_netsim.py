"""The port's packet-level simulator (``repro_torch.net``) against the JAX
package's (``repro.net``): every registered scenario, called in both
packages with the same arguments and seed, over ltp, bbr, cubic and
reno, at loss 0 and 0.01, per packet (``coalesce=1``) and in packet
trains of ``DEFAULT_COALESCE``.

Both simulators are numpy only, so the results must be identical, not
close: completion times, delivered fractions, delivery masks, packet
counts, trunk and ToR-switch statistics (``np.array_equal``), and the
number of events and packets each run moved through its ``Sim``."""
import dataclasses

import numpy as np
import pytest

import repro.net as jnet
import repro.net.simcore as jsimcore
import repro_torch.net as tnet
import repro_torch.net.simcore as tsimcore
from repro.config import NetConfig as JNetConfig
from repro.net import senders as jsenders
from repro_torch.config import NetConfig
from repro_torch.net import senders as tsenders
from repro_torch.runtime.transport import DEFAULT_COALESCE

PROTOCOLS = ("ltp", "bbr", "cubic", "reno")
LOSSES = (0.0, 0.01)
COALESCE = (1, DEFAULT_COALESCE)
# small enough that the whole file runs in seconds: 4 workers, 100 kB a
# worker (70 LTP packets), 2 iterations
GATHER = dict(w=4, size_bytes=1e5, iters=2, seed=3)


def _same(a, b, where="result"):
    """Recursive exact equality over the scenario result types."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        _same(dataclasses.asdict(a), dataclasses.asdict(b), where)
    elif isinstance(a, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), where
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), where
    else:
        assert a == b, (where, a, b)


def _both(call):
    """Run ``call(package_net, package_NetConfig)`` in both packages;
    returns the two results and what each run added to its package's
    ``PERF`` counters (events, packets)."""
    out = []
    for net, cfg, simcore in ((jnet, JNetConfig, jsimcore),
                              (tnet, NetConfig, tsimcore)):
        before = simcore.PERF.snapshot()
        res = call(net, cfg)
        after = simcore.PERF.snapshot()
        out.append((res, {k: after[k] - before.get(k, 0) for k in after}))
    (jres, jperf), (tres, tperf) = out
    return jres, tres, jperf, tperf


def _check(call):
    jres, tres, jperf, tperf = _both(call)
    _same(tres, jres)
    assert tperf == jperf and tperf["events"] > 0
    return tres


GATHERS = {
    "incast": ("incast_gather", {}),
    "multi_ps_1": ("multi_ps_gather", {"n_ps": 1}),
    "multi_ps_2": ("multi_ps_gather", {"n_ps": 2}),
    "multi_ps_4": ("multi_ps_gather", {"n_ps": 4}),
    "straggler": ("straggler_gather", {"slow_rate_mult": 0.5}),
    "cross_traffic": ("cross_traffic", {"bg_load": 0.5}),
}


@pytest.mark.parametrize("coalesce", COALESCE)
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("case", list(GATHERS))
def test_gather_scenarios_are_identical(case, protocol, loss, coalesce):
    name, kw = GATHERS[case]
    rs = _check(lambda net, cfg: net.run_scenario(
        name, protocol, cfg(10, 1, loss, 4096), coalesce=coalesce,
        **GATHER, **kw))
    assert len(rs) == GATHER["iters"]
    for r in rs:
        assert r.masks is not None and r.masks.shape[1] == GATHER["w"]


@pytest.mark.parametrize("coalesce", COALESCE)
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("agg", [True, False])
def test_rack_spine_gather_is_identical(agg, protocol, loss, coalesce):
    rs = _check(lambda net, cfg: net.rack_spine_gather(
        protocol, cfg(10, 1, loss, 4096), 1e5, racks=2,
        workers_per_rack=4, oversub=4.0, agg=agg, iters=2, seed=5,
        coalesce=coalesce))
    if agg and protocol == "ltp":
        # the ToRs merge LTP flows only (DESIGN.md §11)
        assert sum(r.agg_stats["n_merged"] for r in rs) > 0
    else:
        assert all(r.agg_stats is None for r in rs)


@pytest.mark.parametrize("coalesce", COALESCE)
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_topology_gather_is_identical(protocol, coalesce):
    _check(lambda net, cfg: net.topology_gather(
        protocol, cfg(10, 1, 0.01, 4096), topology=net.multi_ps(2),
        coalesce=coalesce, **GATHER))


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_p2p_transfer_is_identical(protocol, loss):
    r = _check(lambda net, cfg: net.p2p_transfer(
        protocol, cfg(1, 1, loss, 256), 2e5, seed=7))
    assert r["fct"] > 0


@pytest.mark.parametrize("coalesce", COALESCE)
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_train_iterations_is_identical(protocol, loss, coalesce):
    r = _check(lambda net, cfg: net.train_iterations(
        protocol, cfg(10, 1, loss, 4096), 4, 1e5, iters=2, seed=3,
        scenario="multi_ps_gather", n_ps=2, coalesce=coalesce))
    assert r["delivery_masks"].shape[:2] == (2, 4)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("pair", [("ltp", "cubic"), ("bbr", "reno"),
                                  ("cubic", "ltp"), ("reno", "bbr")])
def test_fairness_share_is_identical(pair, loss):
    share = _check(lambda net, cfg: net.fairness_share(
        pair[0], pair[1], cfg(1, 1, loss, 256), duration=0.02, seed=2))
    assert abs(sum(share) - 1.0) < 1e-12


def test_registries_and_constants_agree():
    assert tnet.list_scenarios() == jnet.list_scenarios()
    assert tnet.PROTOCOLS == jnet.PROTOCOLS
    for k in ("LTP_PAYLOAD", "MSS"):
        assert getattr(tsenders, k) == getattr(jsenders, k)
    with pytest.raises(ValueError):
        tnet.run_scenario("nope", "ltp", NetConfig())


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_registry_dispatch_matches_direct_call(protocol):
    """``run_scenario`` reaches the same function a direct call does."""
    net = NetConfig(10, 1, 0.01, 4096)
    direct = tnet.incast_gather(protocol, net, **GATHER)
    _same(tnet.run_scenario("incast_gather", protocol, net, **GATHER),
          direct)


# --------------------------------------------------------------------------
# the two replay-determinism bugs the linter's first sweep found in the
# JAX package (tests/test_replint.py), pinned on the port's copies


def test_tcp_prune_inflight_fills_retx_in_seq_order():
    """The retransmit queue refills in seq order, not set-hash order."""
    sim = tsimcore.Sim()
    pipe = tsimcore.Pipe(sim, rate_bps=1e9, delay=0.001)
    snd = tsenders.RenoSender(sim, pipe, deliver=lambda p: None,
                              n_packets=100)
    seqs = [37, 5, 91, 12, 60, 3]
    snd.inflight = set(seqs)
    for s in seqs:
        snd.sent_time[s] = -1e9       # far older than any RTO cutoff
    snd.retx.clear()
    snd._prune_inflight()
    assert list(snd.retx) == sorted(seqs)
    assert snd.inflight == set()


def test_ps_gather_stop_resends_in_flow_order():
    """Post-close stop packets go out in sorted flow order."""
    from repro_torch.net.ltp_receiver import PSGatherReceiver

    sim = tsimcore.Sim()
    stops = []
    rx = PSGatherReceiver(sim, flows=[3, 1, 2], lt_threshold=1.0,
                          deadline=2.0, pct_threshold=0.8,
                          send_stop=stops.append)
    rx.closed = True
    items = [(tsimcore.Packet(f, 0, 100, kind="data"), 0.0)
             for f in (3, 1, 3, 2)]
    rx.on_data_train(items)
    assert stops == [1, 2, 3]
    assert rx.n_stop_resends == 3
