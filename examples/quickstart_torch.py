"""Quickstart on the PyTorch port: the paper's experiment in miniature.

The twin of ``examples/quickstart.py`` on ``repro_torch``: trains the
CIFAR-like CNN over 8 simulated workers + 1 PS with LTP (Early Close +
bubble-filling) vs a lossless TCP-like baseline on a lossy 10G network,
and prints throughput / accuracy side by side, on ``PSTrainer``'s
default engine (the cluster runtime, bsp over the analytic transport).
Runs on the CUDA card (the PS reduction goes through the hand-written
kernels) unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/quickstart_torch.py [--steps 60] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.config import LTPConfig, NetConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCIFAR, batches
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.models.cnn import accuracy
from repro_torch.optim import make_optimizer
from repro_torch.train import PSTrainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--loss-rate", type=float, default=0.001)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back by itself")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("papernet").replace(d_model=16)
    api = build(cfg)
    tc = TrainConfig(batch=128, lr=0.05, steps=args.steps)
    data = SyntheticCIFAR(seed=0)
    test = {k: torch.as_tensor(v).to(device)
            for k, v in data.test_set(1024).items()}
    net = NetConfig(bandwidth_gbps=10, rtprop_ms=1,
                    loss_rate=args.loss_rate, queue_pkts=4096)

    print(f"== papernet on {args.workers} workers, loss={args.loss_rate}, "
          f"device={device} ==")
    # short smoke runs (CI) still get at least one eval at the end
    eval_every = max(1, min(20, args.steps))
    results = {}
    for proto in ["ltp", "cubic"]:
        print(f"\n--- protocol: {proto} ---")
        tr = PSTrainer(api, make_optimizer(tc), tc, LTPConfig(), net,
                       n_workers=args.workers, protocol=proto,
                       compute_time=0.05, seed=0, device=device)
        tr.run(batches(data, tc.batch, tc.steps), epoch_steps=20,
               eval_fn=lambda p: accuracy(cfg, p, test),
               eval_every=eval_every, log_every=10)
        results[proto] = tr
    print("\n== summary ==")
    for proto, tr in results.items():
        accs = [h.get("eval") for h in tr.history if "eval" in h]
        print(f"{proto:6s}: throughput {tr.throughput(tc.batch):7.0f} img/s "
              f"| final acc {accs[-1]:.3f} "
              f"| mean delivered "
              f"{np.mean([h['delivered'] for h in tr.history]):.3f}")
    sp = results["ltp"].throughput(tc.batch) / results["cubic"].throughput(tc.batch)
    print(f"LTP speedup vs cubic: {sp:.2f}x (accuracy preserved)")


if __name__ == "__main__":
    main()
