"""LM training over the LTP parameter server, as a library function.

The port's copy of the JAX package's ``examples/train_lm.py`` (``main``):
a smollm-family LM trained by W workers and one PS through
``PSTrainer`` (the runtime engine, bsp over the analytic transport),
AdamW at lr 3e-4, ``NetConfig(10, 1, 0.001, 4096)``, ``LTPConfig()``
(paper compensation), compute 0.05 s a step, on the synthetic bigram
corpus (``SyntheticLM``, whose loss floor is the chain entropy). The
gradient stream of every step goes through the ``packet_reduce``
kernel on the card, and through ``dropfill``'s error-feedback form when
``error_feedback`` is on.

``lm_trainer`` takes any ported LM config: dense, VLM, MoE
(mixtral-8x22b, deepseek-v2), SSM (falcon-mamba-7b; the zamba2-7b
hybrid) or enc-dec (whisper-small, whose host batches also carry the
stubbed frontend's frames, ``audio_frames``), in float32 or in
bfloat16, the configs' own dtype. The
gradient stream is float32 whatever the model's dtype, and the reduced
stream goes back to each leaf's dtype before the update (a bfloat16
model's norm scales, MoE router and SSM constants stay float32).

``data_vocab`` draws the tokens from a smaller corpus than the model's
vocab: ``SyntheticLM`` builds dense vocab x vocab float64 tables, 19.3
GB each at smollm's 49,152, so a full-vocab model is fed from the 8,192
tokens ``examples/train_lm.py`` itself uses, and keeps every output
column.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import LTPConfig, ModelConfig, NetConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.device import DeviceLike
from repro_torch.models import build
from repro_torch.optim import make_optimizer
from repro_torch.train.dp_sim import PSTrainer


def lm_config(tiny: bool = False) -> ModelConfig:
    """The example's model: smollm-360m's family cut to ~100M
    parameters (12 layers of d_model 768, vocab 8,192), or with ``tiny``
    a 2-layer model of d_model 128 and vocab 512; float32."""
    base = get_config("smollm_360m")
    if tiny:
        cfg = base.replace(n_layers=2, d_model=128, n_heads=4, n_kv=2,
                           head_dim=32, d_ff=256, vocab=512)
    else:
        cfg = base.replace(n_layers=12, d_model=768, n_heads=12, n_kv=4,
                           head_dim=64, d_ff=2048, vocab=8192)
    return cfg.replace(dtype="float32")


def audio_frames(cfg: ModelConfig, batch: int, seed: int,
                 step: int) -> np.ndarray:
    """An enc-dec config's frames for one host batch, in place of the
    stubbed mel + conv frontend: (batch, encoder_frames, d_model)
    float32, 0.02 x N(0, 1), from a numpy generator seeded with
    (``seed``, ``step``)."""
    rng = np.random.default_rng((seed, step))
    return rng.standard_normal((batch, cfg.encoder_frames, cfg.d_model),
                               dtype=np.float32) * np.float32(0.02)


def lm_trainer(cfg: ModelConfig, *, steps: int = 300, workers: int = 8,
               seq: int = 128, batch: int = 32,
               train: Optional[TrainConfig] = None,
               ltp: Optional[LTPConfig] = None,
               net: Optional[NetConfig] = None,
               compute_time: float = 0.05, data_vocab: Optional[int] = None,
               corpus: Optional[SyntheticLM] = None, seed: int = 0,
               device: DeviceLike = None,
               params: Any = None) -> Tuple[PSTrainer, List[Dict]]:
    """The example's ``PSTrainer`` and its ``steps`` host batches, drawn
    from ``corpus``, else from a new ``SyntheticLM(data_vocab or
    cfg.vocab, seed=0)``. ``train`` replaces
    the example's ``TrainConfig(batch, seq, lr=3e-4, optimizer="adamw",
    steps)``; ``params`` starts from a given tree (else the init from
    ``seed``); ``device`` ``None`` means ``cuda``. An enc-dec config's
    batches also carry ``audio_frames(cfg, batch, seed, step)``."""
    lm = corpus or SyntheticLM(vocab=data_vocab or cfg.vocab, seed=0)
    tc = train or TrainConfig(batch=batch, seq=seq, lr=3e-4,
                              optimizer="adamw", steps=steps)
    tr = PSTrainer(build(cfg), make_optimizer(tc), tc,
                   ltp or LTPConfig(), net or NetConfig(10, 1, 0.001, 4096),
                   n_workers=workers, protocol="ltp",
                   compute_time=compute_time, seed=seed, device=device,
                   params=params)
    data = [lm.train_batch(tc.batch, tc.seq, step)
            for step in range(tc.steps)]
    if cfg.family == "audio":
        for step, b in enumerate(data):
            b["frames"] = audio_frames(cfg, tc.batch, seed, step)
    return tr, data


def train_lm(cfg: Optional[ModelConfig] = None, *, steps: int = 300,
             tiny: bool = False, workers: int = 8, seq: int = 128,
             batch: int = 32, ckpt: Optional[str] = None,
             log_every: int = 0, **kw) -> List[Dict]:
    """Train ``cfg`` (default ``lm_config(tiny)``) for ``steps`` steps as
    ``examples/train_lm.py`` does (100-step epochs for the Early Close
    controller) and return the trainer's history; with ``ckpt``, save
    the params to ``<ckpt>.npz``. The other keywords go to
    ``lm_trainer``."""
    cfg = cfg or lm_config(tiny)
    tr, data = lm_trainer(cfg, steps=steps, workers=workers, seq=seq,
                             batch=batch, **kw)
    tr.run(data, epoch_steps=100, log_every=log_every)
    if ckpt:
        save_checkpoint(ckpt, tr.params, step=tr.step_idx)
    return tr.history
