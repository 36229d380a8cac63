"""A whole run of each cell on the CPU at the port's REDUCED widths,
skipping only the look for a card: sound, it comes out correct; with the
timed path broken underneath, or with the float8 control in the
program's place, ``correct`` comes out false."""
import time

import pytest
import torch

from ltpbench import cell as cells
from ltpbench.program import Trainer
from ltpbench.run import reference_run, run_cell

CELLS = cells.on_disk()
SEED = 3 * 2 ** 30 + 7


def _run(name):
    cell = cells.load(name, test_sizes=True)
    return run_cell(cell, SEED, 0.5, False, "cpu", time.perf_counter())


def stale(monkeypatch):
    """A step that returns its state unchanged."""
    import repro_torch.optim as optim
    from repro_torch.tree import tree_map

    make = optim.make_optimizer

    def broken(tc):
        def update(grads, state, params, lr):
            return tree_map(torch.zeros_like, params), state

        return optim.Optimizer(make(tc).init, update)

    monkeypatch.setattr(optim, "make_optimizer", broken)


def half(monkeypatch):
    """Half of each worker's batch left out, the mean over the rest."""
    import dataclasses

    import repro_torch.models as models

    build = models.build

    def broken(cfg):
        api = build(cfg)

        def loss_fn(params, batch, **kw):
            n = batch["tokens"].shape[0] // 2
            return api.loss_fn(params, {k: v[:n] for k, v in batch.items()},
                               **kw)

        return dataclasses.replace(api, loss_fn=loss_fn)

    monkeypatch.setattr(models, "build", broken)


def no_exchange(monkeypatch):
    """The gather between workers left out: each step takes worker 0's
    own gradient."""
    from repro_torch.core import ltp_sync

    monkeypatch.setattr(ltp_sync, "reduce_packet_stream",
                        lambda packets_w, masks_w, *a, **kw: packets_w[0])


def altered_mask(monkeypatch):
    """One worker's delivery of one packet flipped where the runtime
    draws the masks: every rate and norm stays all but the same."""
    import numpy as np
    from repro_torch.runtime import step

    draw = step.draw_delivery_masks

    def broken(plan, w, *a, **kw):
        m = draw(plan, w, *a, **kw)
        crit = np.zeros(plan.n_packets, bool)
        crit[plan.critical] = True
        i = int(np.flatnonzero(~crit)[0])
        m[0, i] = 1.0 - m[0, i]
        return m

    monkeypatch.setattr(step, "draw_delivery_masks", broken)


def control(monkeypatch):
    """The reference with its products in float8 put in the program's
    place."""

    def first_steps(self, batches):
        return reference_run(self.cell, self.seed, batches, self.device,
                             "fp8")

    monkeypatch.setattr(Trainer, "first_steps", first_steps)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 3 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    assert {"tokens_per_s", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("fault", [stale, half, no_exchange, altered_mask,
                                   control],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_broken_run_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(name)
    assert not out["correct"], out["compared"]
