"""The system under test: ``repro_torch``'s LTP parameter-server trainer.

The harness builds the trainer as ``repro_torch.train.lm.lm_trainer``
does (``PSTrainer``, the runtime engine, bsp over the analytic
transport, ``LTPConfig()``: Early Close with paper compensation), but
hands it the benchmark's weights and host batches instead of letting it
draw its own: ``lm_trainer`` would build a bigram corpus of vocab^2
float64 (8.6 GB at Mixtral's full vocabulary) and frames for every one of
``train_steps`` steps. Everything here goes through the package's public
modules, looked up when called, so a test can put a broken part in their
place.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import torch

from ltpbench.reference import weights as W
from ltpbench.reference.trace import Trace

WINDOW_SPAN = "ltpbench.window"


def model_config(config: dict):
    from repro_torch.config import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)} - {"source"}
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in config.items() if k in fields})


class Trainer:
    """The program's trainer for one cell, with the readings the check
    compares taken from its first steps."""

    def __init__(self, cell, seed: int, device):
        t0 = time.perf_counter()
        import repro_torch.models as models
        import repro_torch.optim as optim
        from repro_torch.config import LTPConfig, NetConfig, TrainConfig
        from repro_torch.train.dp_sim import PSTrainer

        t1 = time.perf_counter()
        cfg, wl = cell.config, cell.workload
        self.cell, self.seed, self.device = cell, seed, device
        api = models.build(model_config(cfg))
        self.shapes = cell.reference.param_shapes(cfg)
        params = cell.reference.tree(W.make(self.shapes, seed, device))
        sync(device)
        t2 = time.perf_counter()
        tc = TrainConfig(batch=wl["batch"], seq=wl["seq"], lr=wl["lr"],
                         optimizer=cfg["optimizer"],
                         steps=wl["train_steps"])
        self.tr = PSTrainer(
            api, optim.make_optimizer(tc), tc, LTPConfig(),
            NetConfig(**wl["net"]), n_workers=cfg["workers"],
            protocol="ltp", compute_time=wl["compute_time"], seed=seed,
            device=device, params=params)
        del params
        self.timings = {"program imports": t1 - t0, "weights": t2 - t1,
                        "trainer": time.perf_counter() - t2}

    def first_steps(self, batches: List[dict]) -> Dict[str, list]:
        """Run ``batches`` through ``PSTrainer.run`` and read what the
        check compares: each step's loss, bst, delivered fraction,
        simulated commit time and (W, n_packets) delivery masks, as the
        runtime hands them to the device (packed bits); the first
        gradient as the optimizer got it, from its state after the first
        step (SGD-momentum's buffer; AdamW's first moment over 1 - b1);
        the parameters' change after the last of these steps, against
        the weights made again."""
        import numpy as np
        from repro_torch.tree import tree_leaves

        tr, n0 = self.tr, len(self.tr.history)
        rt = tr._rt
        scale = 1.0 if self.cell.config["optimizer"] == "sgdm" else 1 / 0.1
        grad_norm: list = []
        masks: list = []
        to_device = rt._mask_on_device

        def seen(mask):
            # the host array the step's masks are copied from, unchanged
            masks.append(np.packbits(np.asarray(mask) != 0))
            return to_device(mask)

        def at_commit(params):
            # the runtime's state at the first step's commit: the second
            # step has not been launched yet
            if not grad_norm:
                for m in tree_leaves(tr._rt.opt_state["m"]):
                    grad_norm.append(torch.linalg.vector_norm(
                        m, dtype=torch.float32) * scale)
            return 0.0

        t0 = time.perf_counter()
        rt._mask_on_device = seen
        try:
            tr.run(batches, eval_fn=at_commit, eval_every=1)
        finally:
            del rt._mask_on_device
        sync(self.device)
        t1 = time.perf_counter()
        hist = tr.history[n0:n0 + len(batches)]
        change = []
        for (name, p) in zip(self.shapes, tree_leaves(tr.params)):
            p0 = W.make(self.shapes, self.seed, self.device, [name])[name]
            change.append(float(torch.linalg.vector_norm(
                p.float() - p0.float())))
            del p0
        self.timings["first steps"] = t1 - t0
        self.timings["change norms"] = time.perf_counter() - t1
        return {"loss": [r["loss"] for r in hist],
                "bst": [r["bst"] for r in hist],
                "delivered": [r["delivered"] for r in hist],
                "sim_time": [r["sim_time"] for r in hist],
                "masks": masks,
                "grad_norm": [float(g) for g in grad_norm],
                "change_norm": change}

    def window(self, pool: List[dict], seconds: float) -> dict:
        """``PSTrainer.run`` on ``pool`` again and again until
        ``seconds`` have passed, as a user's loop drives it; the clock
        stops once the device has finished the last step. The pool holds
        more distinct batches than the runtime keeps on the device (its
        last 8 iterations'), so every step copies its batch there."""
        sync(self.device)
        t0 = time.perf_counter()
        ends = []
        while True:
            self.tr.run(pool)
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        sync(self.device)
        steps = len(ends) * len(pool)
        losses = [r["loss"] for r in self.tr.history[-steps:]]
        return {"steps": steps, "seconds": time.perf_counter() - t0,
                "losses": losses, "chunk_ends": ends}

    def profile(self, pool: List[dict]) -> Trace:
        """``PSTrainer.run`` on ``pool`` under ``torch.profiler``."""
        from torch.profiler import ProfilerActivity, profile, \
            record_function

        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        sync(self.device)
        with profile(activities=acts) as prof:
            with record_function(WINDOW_SPAN):
                self.tr.run(pool)
                sync(self.device)
        return to_trace(prof.events(), len(pool))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def release(device) -> None:
    """Free what no one holds any more, and hand the allocator's cached
    blocks back to the device."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def to_trace(events, steps: int) -> Trace:
    """A ``Trace`` of ``torch.profiler``'s events: a device operation's
    launch is the host runtime call that shares its correlation id."""
    from torch.autograd import DeviceType

    host, dev, launch = [], [], {}
    win, main = None, 0
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CPU:
            host.append((e.name, tr.start, tr.end, e.thread))
            if e.name.startswith("cu"):
                launch[e.id] = (tr.start, e.thread)
            if e.name == WINDOW_SPAN:
                win, main = (tr.start, tr.end), e.thread
        elif e.device_type == DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            dev.append([e.name, tr.start, tr.end, e.id])
    ops = []
    for name, a, b, cid in dev:
        at, th = launch.get(cid, (a, main))
        ops.append((name, a, b, at, th))
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    return Trace(device_ops=ops, host_ops=host, window=win,
                 main_thread=main, steps=steps)
