"""Training launcher.

The PyTorch counterpart of the JAX package's ``launch/train.py``, with
its flags. Two modes:

* host (default): the paper's PS training loop in one process, W
  simulated workers (``PSTrainer``), LTP transport (or a TCP baseline),
  synthetic data, checkpoints.

      PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \
          --reduced --steps 100 --protocol ltp --loss-rate 0.001

* sharded: the LTP train step over ``torch.distributed``
  (``train.trainer.make_ltp_train_step``) on the (n_data, world //
  n_data) (data, model) ``DeviceMesh``, as the JAX launcher builds it:
  the data axis is the worker axis, and over ``model`` the model runs
  tensor-parallel, each rank holding its block of the params. Started
  by ``torchrun``, it reads ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``;
  without them it runs as world size 1 over a ``file://`` rendezvous in
  a temporary directory. ``--ckpt`` saves the global params
  (``models.sharding.gather_params``) from rank 0.

      PYTHONPATH=src torchrun --nproc-per-node 1 \
          -m repro_torch.launch.train --mode sharded --steps 10

The backend is ``nccl`` on a CUDA device and ``gloo`` on the CPU; the
device is ``cuda:{LOCAL_RANK}`` unless ``--device cpu``. The delivered
fraction a step is the reference's fixed schedule, ``clip(1 - 10 x
loss_rate, 0.5, 1)`` for every worker, and the step's draws come from
seed ``1 + step``.
"""
from __future__ import annotations

import argparse
import datetime
import os
import tempfile

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import LTPConfig, NetConfig, TrainConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.data import SyntheticLM
from repro_torch.models import build
from repro_torch.optim import make_optimizer

TIMEOUT = datetime.timedelta(minutes=10)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", choices=["host", "sharded"], default="host")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--protocol", default="ltp",
                    choices=["ltp", "bbr", "cubic", "reno"])
    ap.add_argument("--loss-rate", type=float, default=0.001)
    ap.add_argument("--compensation", default="paper",
                    choices=["paper", "count", "expected"])
    ap.add_argument("--n-data", type=int, default=0,
                    help="sharded mode: data-axis size (0 = all ranks)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="cuda (default; cuda:LOCAL_RANK in sharded mode) "
                         "or cpu")
    ap.add_argument("--data-vocab", type=int, default=0,
                    help="draw tokens from a corpus of this many (0 = the "
                         "model's vocab)")
    return ap


def frac_schedule(loss_rate: float, n_data: int) -> torch.Tensor:
    """The reference's fixed delivered fraction, one a worker."""
    f = min(max(1.0 - loss_rate * 10, 0.5), 1.0)
    return torch.full((n_data,), f, dtype=torch.float32)


def init_distributed(device: str = None):
    """The process group for the sharded mode: ``torchrun``'s env vars,
    else world size 1 over a ``file://`` rendezvous in a temporary
    directory. Returns (device, the temporary directory or None)."""
    import torch.distributed as dist

    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device or f"cuda:{local}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the sharded mode runs on a CUDA device by "
                               "default and none is available; pass "
                               "--device cpu")
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    tmp = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=TIMEOUT)
    else:
        tmp = tempfile.TemporaryDirectory()
        dist.init_process_group(
            backend, init_method=f"file://{tmp.name}/rendezvous", rank=0,
            world_size=1, timeout=TIMEOUT)
    return dev, tmp


def run_sharded(args, cfg, api, opt, lm, ltp) -> list:
    """The sharded mode's loop; returns the logged (step, loss, delivered)
    rows of rank 0."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import gather_params
    from repro_torch.train.trainer import init_state, make_ltp_train_step, \
        model_layout

    dev, tmp = init_distributed(args.device)
    rows = []
    try:
        world = dist.get_world_size()
        n_data = args.n_data or world
        mesh = make_host_mesh(n_data, world // n_data)
        if dist.get_rank() == 0:
            print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}; "
                  f"LTP workers = data axis ({n_data}); backend "
                  f"{dist.get_backend()}; device {dev}", flush=True)
        batch_specs = {"tokens": ("data",), "labels": ("data",)}
        step = make_ltp_train_step(api, opt, mesh, ltp, ("data",),
                                   batch_specs)
        state = init_state(api, opt, 0, device=dev, mesh=mesh)
        frac = frac_schedule(args.loss_rate, n_data)
        for s in range(args.steps):
            b = lm.train_batch(args.batch, args.seq, s)
            state, m = step(state, b, frac, 1 + s, args.lr)
            if s % 10 == 0 and dist.get_rank() == 0:
                row = (s, float(m["loss"]), float(m["delivered_frac"]))
                rows.append(row)
                print(f"step {s:4d} loss {row[1]:.4f} delivered "
                      f"{row[2]:.3f}", flush=True)
        if args.ckpt:
            params = gather_params(state.params, model_layout(api, mesh),
                                   mesh)
            if dist.get_rank() == 0:
                save_checkpoint(args.ckpt, params, args.steps)
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            tmp.cleanup()
    return rows


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cfg = (get_reduced if args.reduced else get_config)(args.arch)
    cfg = cfg.replace(dtype="float32")
    api = build(cfg)
    tc = TrainConfig(batch=args.batch, seq=args.seq, lr=args.lr,
                     optimizer="adamw", steps=args.steps)
    opt = make_optimizer(tc)
    lm = SyntheticLM(vocab=args.data_vocab or cfg.vocab, seed=0)
    ltp = LTPConfig(compensation=args.compensation)

    if args.mode == "host":
        from repro_torch.train import PSTrainer

        net = NetConfig(10, 1, args.loss_rate, 4096)
        tr = PSTrainer(api, opt, tc, ltp, net, n_workers=args.workers,
                       protocol=args.protocol, compute_time=0.05, seed=0,
                       device=args.device)
        gen = (lm.train_batch(args.batch, args.seq, s)
               for s in range(args.steps))
        tr.run(gen, epoch_steps=max(1, args.steps // 3), log_every=10)
        print(f"final loss {tr.history[-1]['loss']:.4f} | "
              f"throughput {tr.throughput(args.batch):.1f} seq/s "
              f"(simulated)")
        if args.ckpt:
            save_checkpoint(args.ckpt, tr.params, tr.step_idx)
        return 0
    run_sharded(args, cfg, api, opt, lm, ltp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
