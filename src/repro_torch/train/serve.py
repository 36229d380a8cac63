"""Batched serving: prompt decode + greedy decode over the KV cache, as a
library function.

The port's copy of the JAX package's ``examples/serve.py`` (``main``):
the prompt is processed token by token through ``decode_step`` (the
path every decoder family has), then ``new`` tokens are decoded
greedily, one ``decode_step`` a token for the whole batch. For the
enc-dec family (whisper) that is decode against ``init_cache``'s cross
K/V, which nothing fills, as in the reference example: an encoder-fed
serve composes ``prefill``'s cross K/V into the cache itself. Params come
from a CPU generator seeded with ``seed`` unless ``params`` is given,
and prompts are drawn from it unless ``prompts`` is given.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.configs import get_reduced
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def serve(cfg: Optional[ModelConfig] = None, *, arch: str = "smollm_360m",
          batch: int = 4, prompt_len: int = 16, new: int = 24, seed: int = 0,
          device: DeviceLike = None, params: Any = None,
          prompts: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Serve ``cfg`` (default ``arch``'s REDUCED config at float32).

    Returns the generated tokens (``tokens``, (batch, new) int64), the
    logits ``decode_step`` gave at each prompt position
    (``prompt_logits``, (batch, prompt_len, vocab_padded), on the
    device), the prompts, the host seconds of the prompt phase and of
    the greedy phase (each ending in a synchronise) and the decode
    rate in tokens/s, counted as ``examples/serve.py`` counts it."""
    dev = resolve_device(device)
    cfg = cfg or get_reduced(arch).replace(dtype="float32")
    api = build(cfg)
    if api.decode_step is None:
        raise ValueError(f"{cfg.name} has no serve path")
    gen = torch.Generator().manual_seed(seed)
    if params is None:
        params = api.init(gen, device=dev)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                                generator=gen).numpy()
    toks_in = torch.as_tensor(np.array(prompts)).to(dev)
    cache = api.init_cache(batch, prompt_len + new, torch.float32,
                           device=dev)

    # prompt processing token-by-token (works for every family)
    _sync(dev)
    t0 = time.perf_counter()
    prompt_logits = []
    for t in range(prompt_len):
        logits, cache = api.decode_step(params, cache, toks_in[:, t], t)
        prompt_logits.append(logits)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    # batched greedy decode
    tok = torch.argmax(logits[:, : cfg.vocab], dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(new - 1):
        logits, cache = api.decode_step(params, cache, tok, prompt_len + i)
        tok = torch.argmax(logits[:, : cfg.vocab], dim=-1)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return {
        "tokens": torch.stack(out, dim=1).cpu().numpy(),
        "prompt_logits": torch.stack(prompt_logits, dim=1),
        "prompts": np.asarray(prompts),
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "tokens_per_s": batch * (new - 1) / max(decode_s, 1e-9),
    }
