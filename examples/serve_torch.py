"""Batched serving demo on the PyTorch port: prompt decode + greedy
decode with the KV-cache serve path.

The twin of ``examples/serve.py`` on ``repro_torch``
(``train.serve.serve``), for any ported LM's REDUCED config at float32
(``--arch``: smollm_360m, mixtral_8x22b, deepseek_v2_236b,
falcon_mamba_7b, zamba2_7b, whisper_small, ...). Like the reference
example, it decodes whisper against ``init_cache``'s cross K/V, which
no encoder has filled. Runs on the CUDA card unless ``--device cpu`` is
given.

  PYTHONPATH=src python examples/serve_torch.py [--arch smollm_360m] [--new 24] [--device cpu]
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.train.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back by itself")
    args = ap.parse_args(argv)
    out = serve(arch=args.arch, batch=args.batch, prompt_len=args.prompt_len,
                new=args.new, device=resolve_device(args.device))
    print(f"arch={args.arch} batch={args.batch}")
    print(f"prompt {args.prompt_len} toks: {out['prefill_s']:.2f}s | "
          f"decode {args.new} toks: {out['decode_s']:.2f}s "
          f"({out['tokens_per_s']:.1f} tok/s)")
    for b in range(min(2, args.batch)):
        print(f"  seq{b}: {out['tokens'][b].tolist()}")


if __name__ == "__main__":
    main()
