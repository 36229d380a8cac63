"""``attention_device_ms``: exact on a hand-built trace, the backward's
launches on another thread counted, nothing where the trace, its device
operations or the program's ``fused_attention`` spans are missing (the
program before the fused kernel has none), and its span name the
program's."""
import pytest

from ltpbench import cell as cells
from ltpbench.reference.trace import Trace

read = cells.reader("attention_device_ms")


def _trace(host, device, steps=2):
    """Host spans (name, start, end, thread) and device ops (name, start,
    end, launch time, launch thread), in us."""
    return Trace(device_ops=list(device), host_ops=list(host),
                 window=(0.0, 1000.0), main_thread=1, steps=steps)


def test_reads_device_time_launched_inside_the_spans():
    host = [("bsp_commit", 0, 900, 1), ("encoder", 10, 300, 1),
            ("fused_attention", 20, 30, 1),       # a forward, main thread
            ("fused_attention", 500, 520, 2)]     # a backward, autograd's
    device = [("attn_fwd", 40, 90, 25, 1),        # 50
              ("gemm", 90, 140, 35, 1),           # outside: not counted
              ("attn_bwd_rows", 600, 602, 505, 2),    # 2
              ("attn_bwd_dkdv", 602, 700, 510, 2),    # 98
              ("attn_bwd_dq", 700, 760, 515, 2),      # 60
              ("attn_fwd", 800, 850, 505, 1)]     # thread 1 outside its span
    assert read({"trace": _trace(host, device)}) == \
        pytest.approx((50 + 2 + 98 + 60) / 2 / 1e3)


@pytest.mark.parametrize("trace", [
    None,
    _trace([("encoder", 0, 900, 1)], [("gemm", 0, 10, 5, 1)]),
    _trace([("fused_attention", 0, 900, 1)], []),
], ids=["no_trace", "no_spans", "no_device_ops"])
def test_reads_nothing_without_spans_or_device_ops(trace):
    assert read({"trace": trace}) is None


def test_span_name_is_the_programs():
    from repro_torch.kernels.fused_attention import SPAN

    assert SPAN == "fused_attention"
