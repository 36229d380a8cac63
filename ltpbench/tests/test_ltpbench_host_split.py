"""``ltpbench.host_split``: the split is exact on hand-built counters, the
Whisper cell's window at its CPU test sizes reads each timed span once a
step and every byte copied, and a program without ``host_metrics``
reads nothing."""
import math

import pytest

from ltpbench import cell as cells
from ltpbench import host_split
from ltpbench.reference import ltp


def test_split_is_exact():
    d = {"span/draw_delivery_masks/ns": 60e6, "span/stage_inputs/ns": 30e6,
         "span/bsp_commit/ns": 2_100e6, "span/bsp_commit/calls": 3,
         "h2d/bytes": 3e6, "h2d/batch_misses": 2}
    s = host_split.split(d, 3, 2.3)
    assert s["wall_ms"] == pytest.approx(2_300 / 3)
    assert s["mask_draw_host_ms"] == pytest.approx(20)
    assert s["input_stage_host_ms"] == pytest.approx(10)
    assert s["commit_dispatch_host_ms"] == pytest.approx(690)
    assert s["rest_ms"] == pytest.approx(2_300 / 3 - 20 - 700)
    assert s["h2d_mb_per_step"] == pytest.approx(1)
    assert s["batch_misses"] == 2
    assert s["calls"] == {"draw_delivery_masks": 0, "stage_inputs": 0,
                          "bsp_commit": 3}


def test_window_on_the_cpu():
    cell = cells.load("whisper_small.ltp_bsp", test_sizes=True)
    out = host_split.measure(cell, 2 ** 31 + 5, 0.0, True, "cpu",
                             span_cost=10)
    w = out["window"]
    steps = w["steps"]
    assert steps == cell.workload["chunk_steps"]
    assert w["calls"] == dict.fromkeys(host_split.HOST_SPANS, steps)
    assert w["rest_ms"] >= 0 and w["commit_dispatch_host_ms"] > 0
    # the window's one call finds the set-up's batches on the device
    assert w["batch_misses"] == 0
    # every step copies its masks and fractions (float32), exactly
    sizes = [math.prod(v[0]) for v in
             cell.reference.param_shapes(cell.config).values()]
    n_packets = ltp.PacketLayout.of(sizes).n_packets
    workers = cell.config["workers"]
    assert w["h2d_mb_per_step"] * 1e6 == pytest.approx(
        workers * (n_packets + 1) * 4, rel=1e-12)
    assert out["profiled"]["calls"]["bsp_commit"] == \
        cell.workload["profile_steps"]
    assert out["profiled"]["ps_sync_device_ms"] is None  # no device ops
    assert len(out["span_cost_us"]["timed"]) == 2
    assert out["device"] == "cpu"


def test_no_host_metrics_reads_nothing(monkeypatch):
    from ltpbench import program

    class Bare(program.Trainer):
        def __init__(self, cell, seed, device):
            super().__init__(cell, seed, device)
            self.tr.host_metrics = None

    monkeypatch.setattr(program, "Trainer", Bare)
    cell = cells.load("whisper_small.ltp_bsp", test_sizes=True)
    assert host_split.measure(cell, 3, 0.0, False, "cpu") is None
