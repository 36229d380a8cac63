"""The plain reference against ``repro_torch`` at the port's REDUCED
widths on the CPU: one LTP step of each configuration, and each
configuration's FLOP formula against ``FlopCounterMode``."""
import dataclasses

import pytest
import torch

from ltpbench import cell as cells
from ltpbench import compare, traffic
from ltpbench.program import Trainer, model_config
from ltpbench.reference import numerics
from ltpbench.run import reference_run

CELLS = cells.on_disk()
SEED = 2 ** 31 + 12345
# one bfloat16 step at REDUCED widths: the loss to a few bfloat16 ulps
# of its sum, each leaf's gradient and change norms to a few per cent of
# the median leaf (the CPU's bfloat16 products round each product, where
# cuBLAS accumulates in float32); the host's numbers exactly
TOL = {"first_loss_gap": 1e-3, "grad_gap": 2e-2, "step_gap": 5e-2, "bst_gap": 0.0,
       "sim_time_gap": 0.0, "delivered_gap": 0.0, "mask_gap": 0.0}


@pytest.mark.parametrize("name", CELLS)
def test_test_sizes_are_the_port_reduced(name):
    from repro_torch.configs import get_reduced

    cell = cells.load(name, test_sizes=True)
    red = dataclasses.asdict(get_reduced(cell.config_name))
    run = dataclasses.asdict(model_config(cell.config))
    for k in ("name", "source", *cell.config["port_differs"]):
        run.pop(k), red.pop(k)
    assert run == red


@pytest.mark.parametrize("test_sizes", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_reference_layout_is_the_program_layout(name, test_sizes):
    """The tree the benchmark hands the program has the program's own
    containers, leaf names, shapes and dtypes, in its stream order."""
    import repro_torch.models as models
    from repro_torch.tree import tree_leaves_with_path

    cell = cells.load(name, test_sizes=test_sizes)
    prog = models.build(model_config(cell.config)).init(None, device="meta")
    shapes = cell.reference.param_shapes(cell.config)
    ours = cell.reference.tree({k: torch.empty(v[0], dtype=getattr(
        torch, v[1]), device="meta") for k, v in shapes.items()})

    def leaves(tree):
        return [("/".join(map(str, p)), tuple(x.shape), x.dtype)
                for p, x in tree_leaves_with_path(tree)]

    assert leaves(ours) == leaves(prog)
    assert [k for k, _, _ in leaves(ours)] == list(shapes)
    assert {k: v for k, v in prog.items() if not isinstance(v, dict)} == \
        {k: v for k, v in ours.items() if not isinstance(v, dict)}


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_one_reduced_step(name):
    cell = cells.load(name, test_sizes=True)
    batches = traffic.host_batches(cell.config, cell.workload, SEED, 1,
                                   "cpu")
    prog = Trainer(cell, SEED, "cpu").first_steps(batches)
    ref = reference_run(cell, SEED, batches, "cpu")
    got = compare.gaps(prog, ref)
    assert all(got[k] <= TOL[k] for k in TOL), got
    assert len(prog["grad_norm"]) == len(ref["grad_norm"]) == \
        len(cell.reference.param_shapes(cell.config))


def _program_flops(cell, rows: int, seq: int) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    import repro_torch.models as models

    from ltpbench.reference import weights as W

    cfg = cell.config
    api = models.build(model_config(cfg))
    flat = {k: v.requires_grad_(True) for k, v in
            W.make(cell.reference.param_shapes(cfg), 1, "cpu").items()}
    tree = cell.reference.tree(flat)
    wl = dict(cell.workload, batch=rows, seq=seq)
    batch = traffic.host_batches(dict(cfg), wl, 1, 1, "cpu")[0]
    with FlopCounterMode(display=False) as fc:
        loss = api.loss_fn(tree, batch, remat=False)
        torch.autograd.grad(loss, list(flat.values()))
    return fc.get_total_flops()


@pytest.mark.parametrize("name,seq", [(n, s) for n in CELLS
                                      for s in (16, 256)])
def test_flop_formula(name, seq):
    cell = cells.load(name, test_sizes=True)
    rows = 2
    want = _program_flops(cell, rows, seq)
    got = cell.reference.worker_flops(cell.config, rows, seq)
    assert abs(got - want) <= 1e-3 * want, (got, want)


def test_fp8_control_rounds_every_product():
    x = torch.randn(64, 64, dtype=torch.bfloat16)
    q = numerics.FP8.q(x)
    assert not torch.equal(q, x)
    assert torch.equal(numerics.Exact.q(x), x)
    rel = ((q.float() - x.float()).norm() / x.float().norm()).item()
    assert 1e-3 < rel < 0.1
