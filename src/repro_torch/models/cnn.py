"""papernet — ResNet-style mini CNN for the paper's own CIFAR-10 workload.

The PyTorch counterpart of the JAX package's ``models/cnn.py``, over the
same parameter tree: nested dicts/lists of tensors, conv weights stored
HWIO and images given NHWC, so ``core.packets.flatten`` of the port's
params is bitwise the JAX package's. ``forward`` permutes to NCHW/OIHW
for ``F.conv2d`` inside and reproduces XLA's ``"SAME"`` padding, which
for a 3x3 stride-2 conv on an even input pads 0 before and 1 after.

BatchNorm is replaced by per-position channel LayerNorm so the model is
deterministic under any data sharding.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map

Params = Dict[str, Any]


def _conv_init(gen: torch.Generator, kh, kw, cin, cout) -> torch.Tensor:
    fan_in = kh * kw * cin
    return torch.randn((kh, kw, cin, cout), generator=gen) * (2.0 / fan_in) ** 0.5


def _same_pads(size: int, k: int, stride: int):
    """XLA "SAME": output ceil(size/stride), the extra pad after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1):
    """x: (B, C, H, W); w: (kh, kw, cin, cout) -> "SAME" conv, NCHW."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    w = w_hwio.permute(3, 2, 0, 1)
    if kh == kw == 1 and stride > 1:
        # a 1x1 "SAME" conv pads nothing: it reads every stride-th pixel.
        # Taking them first keeps the conv at stride 1; oneDNN's strided
        # 1x1 backward on a channels-last input corrupts the heap at some
        # batch sizes (4-7, 12, 20: torch 2.13 on the CPU)
        return F.conv2d(x[:, :, ::stride, ::stride], w)
    top, bottom = _same_pads(x.shape[-2], kh, stride)
    left, right = _same_pads(x.shape[-1], kw, stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _chan_norm(x, scale, offset, eps=1e-5):
    """Normalise over channels (dim 1 of NCHW), population variance."""
    mu = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, keepdim=True, unbiased=False)
    return ((x - mu) * torch.rsqrt(var + eps) * scale[:, None, None]
            + offset[:, None, None])


def _norm_p(c):
    return {"scale": torch.ones((c,)), "offset": torch.zeros((c,))}


def init(generator: torch.Generator, cfg: ModelConfig, *,
         device: DeviceLike = None) -> Params:
    """3 stages x (n_layers//3) basic blocks; widths (w, 2w, 4w). Drawn
    from a CPU ``generator`` (the same values on any device), then moved
    to ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    w = cfg.d_model
    blocks_per_stage = max(1, cfg.n_layers // 3)
    g = generator
    params: Params = {
        "stem": {"conv": _conv_init(g, 3, 3, 3, w), **_norm_p(w)},
        "stages": [],
    }
    cin = w
    for s in range(3):
        cout = w * (2**s)
        stage = []
        for b in range(blocks_per_stage):
            stride = 2 if (s > 0 and b == 0) else 1
            blk = {
                "conv1": _conv_init(g, 3, 3, cin, cout),
                "n1": _norm_p(cout),
                "conv2": _conv_init(g, 3, 3, cout, cout),
                "n2": _norm_p(cout),
            }
            if stride != 1 or cin != cout:
                blk["proj"] = _conv_init(g, 1, 1, cin, cout)
            stage.append(blk)
            cin = cout
        params["stages"].append(stage)
    params["fc"] = torch.randn((cin, cfg.vocab), generator=g) * 0.01
    params["fc_b"] = torch.zeros((cfg.vocab,))
    return tree_map(lambda x: x.to(device=dev, dtype=torch.float32), params)


def forward(cfg: ModelConfig, params: Params, images: torch.Tensor):
    """images: (B, 32, 32, 3) float32 -> logits (B, classes)."""
    x = images.permute(0, 3, 1, 2)
    st = params["stem"]
    x = F.relu(_chan_norm(_conv(x, st["conv"]), st["scale"], st["offset"]))
    for s, stage in enumerate(params["stages"]):
        for b, blk in enumerate(stage):
            stride = 2 if (s > 0 and b == 0) else 1
            h = F.relu(_chan_norm(_conv(x, blk["conv1"], stride),
                                  blk["n1"]["scale"], blk["n1"]["offset"]))
            h = _chan_norm(_conv(h, blk["conv2"]), blk["n2"]["scale"],
                           blk["n2"]["offset"])
            skip = _conv(x, blk["proj"], stride) if "proj" in blk else x
            x = F.relu(h + skip)
    x = x.mean(dim=(2, 3))
    return x @ params["fc"] + params["fc_b"]


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    logits = forward(cfg, params, batch["images"]).to(torch.float32)
    labels = batch["labels"].to(torch.int64)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None])[:, 0]
    return nll.mean()


def accuracy(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    logits = forward(cfg, params, batch["images"])
    labels = batch["labels"].to(logits.device)
    return (logits.argmax(-1) == labels).to(torch.float32).mean()
