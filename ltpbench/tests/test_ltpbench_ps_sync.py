"""``ps_sync_device_ms``: exact on a hand-built trace, nothing where the
trace or its spans are missing, its span names the program's, and the
program's profiled step opening each of them."""
import importlib

import pytest

from ltpbench import cell as cells
from ltpbench import traffic
from ltpbench.program import Trainer
from ltpbench.reference.trace import Trace

read = cells.reader("ps_sync_device_ms")


def _trace(host, device, steps=2):
    """Host spans on thread 1 and device ops launched from it, in us."""
    return Trace(device_ops=[(n, a, b, at, 1) for n, a, b, at in device],
                 host_ops=[(n, a, b, 1) for n, a, b in host],
                 window=(0.0, 1000.0), main_thread=1, steps=steps)


def test_reads_device_time_launched_inside_the_sync_spans():
    host = [("bsp_commit", 0, 900), ("worker_grads", 10, 100),
            ("flatten_into", 100, 120), ("ef_gate", 120, 130),
            ("reduce_packet_stream", 130, 140), ("unflatten", 140, 150),
            ("opt_update", 150, 200), ("stage_inputs", 1, 9)]
    device = [("gemm", 20, 300, 50),            # worker_grads: not counted
              ("copy", 300, 340, 110),          # flatten_into: 40
              ("dropfill", 340, 345, 125),      # ef_gate: 5
              ("reduce_kernel<false", 345, 355, 135),   # 10
              ("cat", 355, 358, 145),           # unflatten: 3
              ("adam", 358, 400, 160),          # opt_update: 42
              ("add", 400, 402, 199.5),         # opt_update: 2
              ("h2d", 402, 500, 5)]             # stage_inputs: not counted
    assert read({"trace": _trace(host, device)}) == \
        pytest.approx((40 + 5 + 10 + 3 + 42 + 2) / 2 / 1e3)


@pytest.mark.parametrize("trace", [
    None,
    _trace([("bsp_commit", 0, 900)], [("gemm", 0, 10, 5)]),
    _trace([("flatten_into", 0, 900)], []),
], ids=["no_trace", "no_spans", "no_device_ops"])
def test_reads_nothing_without_spans_or_device_ops(trace):
    assert read({"trace": trace}) is None


def test_span_names_are_the_programs():
    from repro_torch.runtime.step import PS_SYNC_SPANS

    mod = importlib.import_module("ltpbench.metrics.ps_sync_device_ms")
    assert mod.SPANS == PS_SYNC_SPANS


def test_profiled_step_opens_the_sync_spans():
    """Whisper's cell at its CPU test sizes, one profiled step: each span
    of the path but the EF gate (the cell runs without error feedback)
    opens once a step, ``flatten_into`` once a chunk of workers."""
    from repro_torch.runtime.step import worker_chunk

    cell = cells.load("whisper_small.ltp_bsp", test_sizes=True)
    pool = traffic.host_batches(cell.config, cell.workload, 5, 1, "cpu")
    prog = Trainer(cell, 5, "cpu")
    tr = prog.profile(pool)
    w = cell.config["workers"]
    chunks = -(-w // worker_chunk(prog.tr.plan, w))
    assert len(tr.spans("flatten_into")) == chunks
    for name in ("reduce_packet_stream", "unflatten", "opt_update"):
        assert len(tr.spans(name)) == 1, name
    assert not tr.spans("ef_gate")
    assert read({"trace": tr}) is None       # no device operations here
