"""Train a smollm-family LM with LTP-synced gradients on the PyTorch port.

The twin of ``examples/train_lm.py`` on ``repro_torch``
(``train.lm.train_lm``): the ~100M-parameter smollm-family model (or a
2-layer one with ``--tiny``) trained by 8 simulated workers and one PS
on the synthetic bigram corpus, AdamW, the Early Close controller and
packet masks; a checkpoint is written at the end. ``--arch`` trains a
ported architecture's REDUCED config instead (``mixtral_8x22b``,
``deepseek_v2_236b``, ``falcon_mamba_7b``, ``zamba2_7b`` and the enc-dec
``whisper_small``, fed synthetic frames, among them) at its own dtype,
bfloat16. Runs on
the CUDA card (the PS reduction goes through the hand-written kernels)
unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 300 [--tiny] [--device cpu]
  PYTHONPATH=src python examples/train_lm_torch.py --arch mixtral_8x22b [--device cpu]
  PYTHONPATH=src python examples/train_lm_torch.py --arch falcon_mamba_7b|zamba2_7b [--device cpu]
  PYTHONPATH=src python examples/train_lm_torch.py --arch whisper_small [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.train.lm import lm_config, train_lm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true",
                    help="2-layer model for a fast demo run")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--arch", default=None,
                    help="a ported architecture's REDUCED config in place "
                         "of the example's model")
    ap.add_argument("--ckpt", default="/tmp/repro_torch_lm_ckpt")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back by itself")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = lm_config(args.tiny) if args.arch is None else \
        get_reduced(args.arch)
    floor = SyntheticLM(vocab=cfg.vocab, seed=0).entropy_floor
    print(f"model: {cfg.name} on {device}; bigram entropy floor "
          f"{floor:.3f} nats (init loss ~ {np.log(cfg.vocab):.3f})")
    t0 = time.time()
    hist = train_lm(cfg, steps=args.steps, workers=args.workers,
                    seq=args.seq, batch=args.batch, ckpt=args.ckpt,
                    log_every=10, device=device)
    print(f"wall {time.time()-t0:.0f}s, simulated {hist[-1]['sim_time']:.0f}s, "
          f"final loss {hist[-1]['loss']:.4f} (floor {floor:.3f})")
    print(f"checkpoint -> {args.ckpt}.npz")


if __name__ == "__main__":
    main()
