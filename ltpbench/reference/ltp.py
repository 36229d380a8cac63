"""Plain reference of LTP parameter-server training (paper §III).

W workers each take the gradient of their share of the batch; a
parameter server gathers them over a lossy network that it closes early
(the double time-threshold Early Close, §III-B), fills the packets it
never received with zeros (bubble filling, §III-C) and averages what it
has over all W workers ("paper" compensation); the optimizer then takes
one step. This module holds that semantics in plain numpy and PyTorch,
written from the paper and the configuration alone:

* ``PacketLayout``: the gradient leaves laid end to end in one float
  stream, cut into packets of 360 floats; the packets holding the first
  and the last float of each leaf are critical and always delivered.
* ``incast_sample`` / ``EarlyClose`` / ``broadcast_time``: the simulated
  network's gather times, the close decision and each worker's delivered
  fraction, in float64 numpy. These are host numbers and must equal the
  program's exactly, so their expressions keep the order of the paper's
  formulas as the project states them (an incast drain of W x the model
  over the shared 10 Gb/s link plus one RTprop; 15 % of flows stretched
  by an exponential tail of mean 1.5; goodput divided by (1 - p)^2).
* ``follow``: the first steps of training from given weights and host
  batches, each worker's gradient taken one worker at a time with
  autograd, each leaf masked packet by packet and summed in float32.

Nothing here imports the program: the weights and batches come from the
benchmark, and every number the program derives from them is worked out
again here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

PACKET_FLOATS = 360
# Early Close (paper §III-B): received-data threshold, LT_init multiple of
# RTprop, deadline slack C (DCN)
PCT_THRESHOLD = 0.8
LT_INIT_RTPROP_MULT = 1.5
DEADLINE_C_MS = 30.0
# the analytic incast's long tail
TAIL_PROB = 0.15
TAIL_SCALE = 1.5


@dataclasses.dataclass(frozen=True)
class PacketLayout:
    sizes: tuple
    offsets: tuple
    n_floats: int
    n_packets: int
    critical: np.ndarray

    @classmethod
    def of(cls, sizes: Sequence[int], packet: int = PACKET_FLOATS,
           critical_per_tensor: int = 1) -> "PacketLayout":
        sizes = tuple(int(s) for s in sizes)
        offsets = tuple(int(o) for o in np.cumsum((0,) + sizes)[:-1])
        n_floats = int(sum(sizes))
        n_packets = max(1, -(-n_floats // packet))
        crit = np.zeros(n_packets, bool)
        c = critical_per_tensor
        for off, sz in zip(offsets, sizes):
            first, last = off // packet, (off + sz - 1) // packet
            crit[first:min(first + c, n_packets)] = True
            crit[max(last - c + 1, 0):last + 1] = True
        return cls(sizes, offsets, n_floats, n_packets, crit)

    def leaf_mask(self, i: int, packet_mask: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s elements' delivery (float32, flat) from one
        worker's (n_packets,) packet mask."""
        off, sz = self.offsets[i], self.sizes[i]
        first, last = off // PACKET_FLOATS, (off + sz - 1) // PACKET_FLOATS
        lo = off - first * PACKET_FLOATS
        per = packet_mask[first:last + 1].repeat_interleave(PACKET_FLOATS)
        return per[lo:lo + sz]


def incast_sample(rng: np.random.Generator, net: dict, w: int,
                  model_bytes: float):
    """One gather of ``model_bytes`` from each of ``w`` workers: (time at
    which each worker's last byte lands, time of its first byte)."""
    bw = net["bandwidth_gbps"] * 1e9 / 8
    rt = net["rtprop_ms"] * 1e-3
    base = model_bytes * w / bw + rt
    infl = 1.0 / max(1e-6, (1.0 - net["loss_rate"]) ** 2)
    tails = np.where(rng.random(w) < TAIL_PROB,
                     rng.exponential(TAIL_SCALE, w), 0.0)
    return base * infl * (1.0 + tails) + np.zeros(w), np.full(w, rt)


def broadcast_time(net: dict, model_bytes: float) -> float:
    bw = net["bandwidth_gbps"] * 1e9 / 8
    rt = net["rtprop_ms"] * 1e-3
    return rt + model_bytes / 1 / bw


class EarlyClose:
    """Per-link LT thresholds, the deadline and the close decision."""

    def __init__(self, net: dict, w: int, model_bytes: float):
        rt = net["rtprop_ms"] * 1e-3
        share = net["bandwidth_gbps"] * 1e9 / 8 / w
        self.lt = np.full(w, LT_INIT_RTPROP_MULT * rt
                          + float(model_bytes / 1) / share)

    def step(self, t_full: np.ndarray, t0: np.ndarray):
        lt = float(self.lt.max())
        dl = float(self.lt.max() + DEADLINE_C_MS * 1e-3)

        def pct(t):
            return np.clip((t - t0) / np.maximum(t_full - t0, 1e-12),
                           0.0, 1.0)

        if float(t_full.max()) <= lt:
            close = float(t_full.max())
        elif pct(dl).mean() < PCT_THRESHOLD:
            close = dl
        elif pct(lt).mean() >= PCT_THRESHOLD:
            close = lt
        else:
            lo, hi = lt, dl
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                if pct(mid).mean() >= PCT_THRESHOLD:
                    hi = mid
                else:
                    lo = mid
            close = hi
        return float(close), np.mean([pct(close)], axis=0)


# ----------------------------------------------------------------------------
# optimizers (updates added to the params, kept in each leaf's dtype)
# ----------------------------------------------------------------------------


def sgdm_step(state, params, grads, lr, momentum=0.9):
    for k, p in params.items():
        m = state.setdefault(k, torch.zeros_like(p))
        m = momentum * m + grads[k].to(m.dtype)
        state[k] = m
        params[k] = p + (-lr * m).to(p.dtype)


def adamw_step(state, params, grads, lr, b1=0.9, b2=0.95, eps=1e-8):
    t = state["t"] = state.get("t", 0) + 1
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
    for k, p in params.items():
        g = grads[k].float()
        m = b1 * state.get(("m", k), torch.zeros_like(g)) + (1 - b1) * g
        v = b2 * state.get(("v", k), torch.zeros_like(g)) \
            + (1 - b2) * torch.square(g)
        state[("m", k)], state[("v", k)] = m, v
        upd = (m / c1.to(g.device)) / (torch.sqrt(v / c2.to(g.device)) + eps)
        params[k] = p + (-lr * upd).to(p.dtype)


OPTIMIZERS = {"sgdm": sgdm_step, "adamw": adamw_step}


# ----------------------------------------------------------------------------
# the first steps
# ----------------------------------------------------------------------------


def worker_rows(batch: dict, w: int, n_workers: int) -> dict:
    """Worker ``w``'s contiguous share of a host batch, on no device."""
    rows = next(iter(batch.values())).shape[0] // n_workers
    return {k: v[w * rows:(w + 1) * rows] for k, v in batch.items()}


def follow(loss_fn: Callable, params: Dict[str, torch.Tensor],
           batches: List[dict], *, workers: int, optimizer: str, lr: float,
           net: dict, compute_time: float, seed: int, device,
           fault: Optional[str] = None) -> dict:
    """``len(batches)`` steps of LTP training from ``params`` (a flat
    dict, leaf name -> tensor on ``device``, in the stream's leaf order;
    updated in place). ``loss_fn(params, worker_batch)`` is one worker's
    loss. Returns each step's mean loss, bst, delivered fraction,
    simulated commit time and (W, n_packets) delivery masks (packed
    bits), the first step's mean gradient's norm by leaf, and the
    parameters' change by leaf after the last step.

    ``fault`` plants one of the faults a broken program could have, for
    the readings that set a limit's upper end: ``half`` (each worker's
    gradient and loss over the first half of its rows), ``no_exchange``
    (the step takes worker 0's own gradient, nothing gathered)."""
    names = list(params)
    layout = PacketLayout.of([params[k].numel() for k in names])
    model_bytes = layout.n_floats * 4
    gather_rng = np.random.default_rng(seed + 1)
    mask_rng = np.random.default_rng(seed + 23)
    ec = EarlyClose(net, workers, model_bytes)
    p0 = {k: v.clone() for k, v in params.items()}
    step_fn = OPTIMIZERS[optimizer]
    state: dict = {}
    out = {"loss": [], "bst": [], "delivered": [], "sim_time": [],
           "masks": []}
    t = 0.0
    for it, batch in enumerate(batches):
        t_full, t_first = incast_sample(gather_rng, net, workers,
                                        model_bytes)
        close, frac = ec.step(t_full, t_first)
        bst = close + broadcast_time(net, model_bytes)
        masks = (mask_rng.random((workers, layout.n_packets))
                 < np.asarray(frac)[:, None]).astype(np.float32)
        masks[:, layout.critical] = 1.0
        t = (t + compute_time) + bst
        acc = {k: torch.zeros(params[k].shape, dtype=torch.float32,
                              device=device) for k in names}
        losses = []
        for w in range(workers):
            rows = worker_rows(batch, w, workers)
            if fault == "half":
                rows = {k: v[:v.shape[0] // 2] for k, v in rows.items()}
            leaves = [params[k].detach().requires_grad_(True) for k in names]
            loss = loss_fn(dict(zip(names, leaves)), rows)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(loss.detach().float())
            pm = torch.from_numpy(masks[w]).to(device)
            for i, (k, g) in enumerate(zip(names, grads)):
                if fault == "no_exchange":
                    if w == 0:
                        acc[k] = g.float() * workers
                    continue
                acc[k] += g.float() * layout.leaf_mask(i, pm).view(g.shape)
            del grads, leaves, loss
        mean = {k: (acc[k] / workers).to(params[k].dtype) for k in names}
        del acc
        if it == 0:
            out["grad_norm"] = [_norm(mean[k]) for k in names]
        step_fn(state, params, mean, lr)
        del mean
        out["loss"].append(float(torch.stack(losses).mean()))
        out["bst"].append(bst)
        out["delivered"].append(float(torch.from_numpy(masks).to(device)
                                      .mean()))
        out["sim_time"].append(t)
        out["masks"].append(np.packbits(masks != 0))
    out["change_norm"] = [_norm(params[k].float() - p0[k].float())
                          for k in names]
    return out


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.float()))
