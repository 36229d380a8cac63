"""The fused attention (``kernels/fused_attention.py``), which full
attention (no causal mask, no window) on a CUDA tensor takes in place of
the chunk loop of ``models/attention.py``.

On the CPU:

- the CPU route is the chunk loop, bitwise; causal and windowed calls
  never reach the operator, on CPU or fake CUDA tensors, and full
  attention on a fake CUDA tensor does, with the loop's shape and dtype;
- the kernels' plain versions (below: O and the LSE, then dq, dk, dv
  from them, at the kernels' rounding points) against the loop and its
  autograd, in float32;
- the two Functions' wiring, their launches done by those plain versions
  on CPU tensors: the ``vmap`` rules fold a mapped axis in any position,
  or repeat an unmapped input, forward and backward; Whisper's losses and
  grads under ``vmap(grad_and_value)`` with remat match the loop's, with
  one forward launch a layer and pass (forward, recompute) and one
  backward a layer, per ``vmap`` call;
- the dry-run: the operators' fake forms on ``meta`` tensors inside
  ``shape_only``, their cost formulas against ``FlopCounterMode``'s count
  of the loop, and Whisper's counted FLOPs equal to the loop's.

On the card (``python -m pytest tests/test_torch_fused_attention.py -m
card``; this file imports no JAX): the kernels against the chunk loop
run there, forward and grads, within twice a one-ulp rounding control;
the same in float32 and at a ragged, grouped-query shape of head size
32; the same through Whisper's fused step (``vmap(grad_and_value)``,
``_Remat``) with 48 forward and 24 backward launches a worker chunk;
two runs equal bit for bit.
"""
import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.func import grad, grad_and_value, vmap
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import _build
from repro_torch.kernels import fused_attention as fa
from repro_torch.launch import cost
from repro_torch.launch.cost import CostCounter
from repro_torch.models import attention, build
from repro_torch.tree import tree_leaves, tree_map

# (q shape, k / v shape): GQA, ragged lengths, one query row
SHAPES = [((2, 7, 4, 16), (2, 13, 2, 16)),
          ((3, 5, 2, 8), (3, 5, 2, 8)),
          ((2, 1, 4, 16), (2, 9, 4, 16))]
CASES = [(False, 0, True), (True, 0, False), (True, 4, False),
         (False, 4, False)]


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _qkv(qs, ks, dtype=torch.float32, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(s, generator=gen).to(device=device, dtype=dtype)
                 for s in (qs, ks, ks))


class Ops(TorchDispatchMode):
    """The names of the operators dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func._schema.name)
        return func(*args, **(kwargs or {}))


def _loop(q, k, v):
    return attention.chunked_attention(q, k, v, causal=False)


# ----------------------------------------------------------------------------
# routing
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window,_", CASES)
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_cpu_route_is_the_chunk_loop(causal, window, _, shape, monkeypatch):
    q, k, v = _qkv(*SHAPES[shape], torch.bfloat16)
    monkeypatch.setattr(attention, "fused_attention", None)   # never called
    before = fa.LAUNCHES
    got = attention.multi_head_attention(q, k, v, causal=causal,
                                         window=window, chunk_q=4)
    want = attention.chunked_attention(q, k, v, causal=causal, window=window,
                                       chunk_q=4)
    assert torch.equal(got, want) and fa.LAUNCHES == before


@pytest.mark.parametrize("causal,window,fused", CASES)
def test_routing_on_device_tensors(causal, window, fused):
    """``meta`` tensors inside a shape-only run stand for CUDA ones here
    (the chunk loop itself does not run on fake CUDA tensors in a CPU
    build of torch); full attention on a fake CUDA tensor below."""
    qs, ks = SHAPES[0]
    q, k, v = (torch.empty(s, dtype=torch.bfloat16, device="meta")
               for s in (qs, ks, ks))
    with _build.shape_only(), Ops() as seen:
        out = attention.multi_head_attention(q, k, v, causal=causal,
                                             window=window)
    assert tuple(out.shape) == qs and out.dtype == torch.bfloat16
    names = set(seen.names)
    assert ("repro_torch::fused_attention_fwd_into" in names) == fused
    assert fused == (not any(n.startswith("aten::bmm") for n in names))


@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_full_attention_on_fake_cuda_reaches_the_operator(shape):
    qs, ks = SHAPES[shape]
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
    with FakeTensorMode():
        q, k, v = (torch.empty(s, dtype=torch.bfloat16, device="cuda")
                   for s in (qs, ks, ks))
        with Ops() as seen:
            out = attention.multi_head_attention(q, k, v, causal=False)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == before
    assert tuple(out.shape) == qs and out.dtype == torch.bfloat16
    assert out.device == torch.device("cuda", 0)
    assert seen.names.count("repro_torch::fused_attention_fwd_into") == 1


@pytest.mark.parametrize("dims", [(0, 0, 0), (1, 2, 3), (3, None, 1)])
def test_vmap_rules_on_fake_cuda(dims):
    """The forward's and the backward's rules fold a mapped axis of 3, in
    any position or absent, into the operators' batch (12 = 3 x 4) and
    unfold it, on fake CUDA tensors."""
    n, (qs, ks) = 3, ((4, 7, 4, 16), (4, 13, 2, 16))

    def mapped(shape, d, dtype=torch.bfloat16):
        if d is None:
            return torch.empty(shape, dtype=dtype, device="cuda")
        t = torch.empty((n,) + shape, dtype=dtype, device="cuda")
        return t.movedim(0, d)

    with FakeTensorMode():
        q, k, v = (mapped(s, d) for s, d in zip((qs, ks, ks), dims))
        with Ops() as seen:
            o, lse = vmap(fa._Attention.apply, in_dims=dims)(q, k, v)
            lse_f = mapped(lse.shape[1:], 0, torch.float32)
            grads = vmap(fa._AttentionBackward.apply,
                         in_dims=dims + (0, 0))(q, k, v, lse_f,
                                                mapped(qs, 0))
    assert tuple(o.shape) == (n,) + qs and o.dtype == torch.bfloat16
    assert tuple(lse.shape) == (n, qs[0], qs[2], qs[1])
    assert lse.dtype == torch.float32
    for g, s in zip(grads, (qs, ks, ks)):
        assert tuple(g.shape) == (n,) + s and g.dtype == torch.bfloat16
    calls = [n for n in seen.names if n.startswith("repro_torch::")]
    assert calls == ["repro_torch::fused_attention_fwd_into",
                     "repro_torch::fused_attention_bwd_into"]


def test_fused_attention_refuses_cpu_and_mixed_dtypes():
    q, k, v = _qkv(*SHAPES[0])
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.fused_attention(q, k, v)
    with _build.shape_only(), pytest.raises(TypeError, match="float32"):
        fa.fused_attention(q.to("meta"), k.to("meta").half(), v.to("meta"))
    with pytest.raises(ValueError, match="head sizes"):   # hd 16
        fa._forward_into(q, k, v, None, None)


# ----------------------------------------------------------------------------
# the kernels' plain versions against the chunk loop
# ----------------------------------------------------------------------------


def _heads(k: torch.Tensor, h: int) -> torch.Tensor:
    """(B, Sk, KV, hd) -> (B, Sk, H, hd): KV head h // G for query head h."""
    return k.repeat_interleave(h // k.shape[2], dim=2)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, H, Sq, Sk) float32: QK^T in q's dtype, scaled in float32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, _heads(k, q.shape[2]))
    return s.to(torch.float32) * (1.0 / math.sqrt(q.shape[3]))


def fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The kernels' forward at their rounding points: (O in q's dtype, the
    rows' log-sum-exp (B, H, Sq) float32); P normalised in float32, then
    rounded. q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd)."""
    s = _scores(q, k)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, _heads(v, q.shape[2]))
    return o.to(q.dtype), lse


def bwd_ref(q, k, v, lse, do):
    """The kernels' backward at their rounding points: (dq, dk, dv) from
    the forward's LSE and the output's grad ``do``."""
    h, dt = q.shape[2], q.dtype
    p = torch.exp(_scores(q, k) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do, _heads(v, h)).to(dt).float()
    rows = (p * dp).sum(-1)                                     # (B, H, Sq)
    ds = (p * (dp - rows[..., None]) * (1.0 / math.sqrt(q.shape[3]))).to(dt)
    g = h // k.shape[2]

    def per_kv(x):
        # (B, Sk, H, hd) -> (B, Sk, KV, hd), the group's heads summed
        return x.float().unflatten(2, (k.shape[2], g)).sum(3).to(dt)

    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _heads(k, h))
    dk = per_kv(torch.einsum("bhqk,bqhd->bkhd", ds, q))
    dv = per_kv(torch.einsum("bhqk,bqhd->bkhd", p.to(dt), do))
    return dq, dk, dv


@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_plain_versions_match_the_chunk_loop(shape):
    q, k, v = (t.requires_grad_() for t in _qkv(*SHAPES[shape], seed=1))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(2))
    want = attention.chunked_attention(q, k, v, causal=False, chunk_q=2)
    grads = torch.autograd.grad(want, (q, k, v), do)
    with torch.no_grad():
        o, lse = fwd_ref(q, k, v)
        got = bwd_ref(q, k, v, lse, do)
        s = _scores(q, k)
    torch.testing.assert_close(o, want.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1))
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    for g, w in zip(got, grads, strict=True):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------------
# the Functions' wiring, launches done by the plain versions
# ----------------------------------------------------------------------------


@pytest.fixture
def emulated(monkeypatch):
    """Full attention on CPU tensors routed to the Functions, whose
    launches the plain versions do; yields the launches counted."""
    calls = {"fwd": 0, "bwd": 0, "fwd_batch": []}

    def fwd(q, k, v, o, lse):
        calls["fwd"] += 1
        calls["fwd_batch"].append(q.shape[0])
        for t, x in zip((o, lse), fwd_ref(q, k, v)):
            t.copy_(x)

    def bwd(q, k, v, lse, do, dq, dk, dv):
        calls["bwd"] += 1
        for t, x in zip((dq, dk, dv),
                        bwd_ref(q, k, v, lse, do)):
            t.copy_(x)

    monkeypatch.setattr(fa, "_forward_into", fwd)
    monkeypatch.setattr(fa, "_backward_into", bwd)
    monkeypatch.setattr(_build, "on_device", lambda t: True)
    monkeypatch.setattr(_build, "launching", lambda t: t.device.type == "cpu")
    return calls


def _mapped(t, n, d, seed):
    """``t`` with a mapped axis of size ``n`` at ``d`` (None: unmapped)."""
    if d is None:
        return t
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n,) + t.shape, generator=gen).movedim(0, d)


@pytest.mark.parametrize("dims", [(0, 0, 0), (1, 2, 3), (3, None, 1),
                                  (None, 0, 0), (2, 4, None)])
def test_vmap_rules_fold_any_axis(emulated, dims):
    n = 3
    qs, ks = SHAPES[0]
    q, k, v = (_mapped(t, n, d, 5 + i) for i, (t, d) in
               enumerate(zip(_qkv(qs, ks), dims)))
    w = torch.randn(qs, generator=torch.Generator().manual_seed(9))

    def loss(q, k, v):
        out = attention.multi_head_attention(q, k, v, causal=False)
        return (out * w).sum()

    out = vmap(lambda q, k, v: attention.multi_head_attention(
        q, k, v, causal=False), in_dims=dims)(q, k, v)
    grads = vmap(grad(loss, argnums=(0, 1, 2)), in_dims=dims)(q, k, v)
    assert emulated["fwd"] == 2 and emulated["bwd"] == 1
    assert emulated["fwd_batch"] == [n * qs[0]] * 2
    for i in range(n):
        qi, ki, vi = (t if d is None else t.select(d, i) for t, d in
                      zip((q, k, v), dims))
        qi, ki, vi = (t.detach().requires_grad_() for t in (qi, ki, vi))
        want = _loop(qi, ki, vi)
        torch.testing.assert_close(out[i], want.detach(), rtol=1e-5,
                                   atol=1e-6)
        gw = torch.autograd.grad((want * w).sum(), (qi, ki, vi))
        for g, x, d in zip(grads, gw, dims):
            torch.testing.assert_close(g[i], x, rtol=1e-5, atol=1e-6)


def _whisper_grads(cfg, params, batch):
    api = build(cfg)

    def one(p, b):
        return grad_and_value(lambda q: api.loss_fn(q, b, remat=True))(p)

    return vmap(one, in_dims=(None, 0))(params, batch)


def _whisper_inputs(cfg, workers, b, s, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    lead = (workers, b)
    batch = {
        "frames": torch.as_tensor((rng.normal(size=lead + (
            cfg.encoder_frames, cfg.d_model)) * 0.02).astype(np.float32)),
        "tokens": torch.as_tensor(rng.integers(0, cfg.vocab, lead + (s,))),
        "labels": torch.as_tensor(rng.integers(-1, cfg.vocab, lead + (s,)))}
    params = build(cfg).init(torch.Generator().manual_seed(seed),
                             device=device)
    return params, {k: v.to(device) for k, v in batch.items()}


def test_whisper_step_wiring_matches_the_chunk_loop(emulated, monkeypatch):
    """REDUCED whisper-small in float32, two workers under one ``vmap``,
    remat on: losses and every grad against the chunk loop's."""
    cfg = get_reduced("whisper_small").replace(dtype="float32")
    params, batch = _whisper_inputs(cfg, 2, 2, 8, seed=3)
    g1, l1 = _whisper_grads(cfg, params, batch)
    n = cfg.encoder_layers + cfg.n_layers
    assert (emulated["fwd"], emulated["bwd"]) == (2 * n, n)
    assert set(emulated["fwd_batch"]) == {2 * 2}
    monkeypatch.setattr(_build, "on_device", lambda t: False)
    g0, l0 = _whisper_grads(cfg, params, batch)
    assert emulated["fwd"] == 2 * n
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0), strict=True):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


# ----------------------------------------------------------------------------
# the dry-run
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_attention_cost_is_the_chunk_loops_flops(shape):
    qs, ks = SHAPES[shape]
    q, k, v = (t.requires_grad_() for t in _qkv(qs, ks))
    with FlopCounterMode(display=False) as fwd:
        out = _loop(q, k, v)
    with FlopCounterMode(display=False) as bwd:
        out.sum().backward()
    n_bytes, ops = cost.attention_cost(qs, ks, 2)
    assert fwd.get_total_flops() == ops == 4 * math.prod(qs) * ks[1]
    assert cost.attention_cost(qs, ks, 2, True)[1] == \
        bwd.get_total_flops() == 2 * ops
    nq, nkv = math.prod(qs), math.prod(ks)
    rows = qs[0] * qs[1] * qs[2] * 4
    assert n_bytes == (2 * nq + 2 * nkv) * 2 + rows
    assert cost.attention_cost(qs, ks, 2, True)[0] == \
        (3 * nq + 4 * nkv) * 2 + rows


@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_fake_forms_on_meta(shape):
    qs, ks = SHAPES[shape]
    q, k, v = (torch.empty(s, device="meta", dtype=torch.bfloat16)
               for s in (qs, ks, ks))
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
    with _build.shape_only(), CostCounter() as c:
        qg, kg, vg = (t.requires_grad_() for t in (q, k, v))
        out = attention.multi_head_attention(qg, kg, vg, causal=False)
        grads = torch.autograd.grad(out.sum(), (qg, kg, vg))
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == before
    assert tuple(out.shape) == qs and out.dtype == torch.bfloat16
    for g, t in zip(grads, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype
    kern = c.cost.kernels
    for name, bwd in (("fused_attention_fwd_into", False),
                      ("fused_attention_bwd_into", True)):
        n_bytes, ops = cost.attention_cost(qs, ks, 2, bwd)
        assert kern[name] == {"calls": 1, "bytes": n_bytes, "ops": ops}
    assert c.cost.flops == 3 * cost.attention_cost(qs, ks, 2)[1]


def test_whisper_dryrun_flops_equal_the_chunk_loops():
    """Whisper's loss and grads counted on ``meta`` tensors: the chunk
    loop outside ``shape_only``, the operators inside it; the FLOPs
    equal, one forward operator a layer and pass, one backward."""
    cfg = get_reduced("whisper_small").replace(dtype="float32")
    api = build(cfg)
    params = api.init(None, device="meta")
    batch = {"frames": torch.empty((2, cfg.encoder_frames, cfg.d_model),
                                   device="meta"),
             "tokens": torch.empty((2, 32), dtype=torch.int64, device="meta"),
             "labels": torch.empty((2, 32), dtype=torch.int64, device="meta")}

    def run():
        grad_and_value(lambda p: api.loss_fn(p, batch))(params)

    with CostCounter() as plain:
        run()
    with _build.shape_only(), CostCounter() as fused:
        run()
    n = cfg.encoder_layers + cfg.n_layers
    assert fused.cost.flops == plain.cost.flops > 0
    assert fused.cost.kernels["fused_attention_fwd_into"]["calls"] == 2 * n
    assert fused.cost.kernels["fused_attention_bwd_into"]["calls"] == n
    assert not plain.cost.kernels


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

CARD_SHAPES = [((20, 1500, 12, 64), (20, 1500, 12, 64)),
               ((20, 128, 12, 64), (20, 1500, 12, 64)),
               ((4, 1, 12, 64), (4, 1500, 12, 64))]


def _nudged(x, seed):
    """``x`` with every element moved one unit in its last place, up or
    down at random: the input of a rounding control."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    up = torch.rand(x.shape, device=x.device, generator=gen) < 0.5
    return torch.nextafter(x, torch.where(up, math.inf, -math.inf).to(
        x.dtype))


def _fwd_bwd(fn, q, k, v, do):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = fn(q, k, v)
    return (o.detach(),) + torch.autograd.grad(o, (q, k, v), do)


def _distance(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a, b, strict=True))


@pytest.mark.card
@pytest.mark.parametrize("shape", range(len(CARD_SHAPES)))
def test_card_kernels_match_the_chunk_loop(card, shape):
    qs, ks = CARD_SHAPES[shape]
    q, k, v = _qkv(qs, ks, torch.bfloat16, seed=shape, device=card)
    do = torch.randn(qs, generator=torch.Generator().manual_seed(7)).to(
        device=card, dtype=torch.bfloat16)
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
    got = _fwd_bwd(fa.fused_attention, q, k, v, do)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    plain = _fwd_bwd(_loop, q, k, v, do)
    control = _fwd_bwd(_loop, *(_nudged(t, 11 + i) for i, t in
                                enumerate((q, k, v, do))))
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        assert got[i].dtype == plain[i].dtype == torch.bfloat16
        err = _distance(got[i:i + 1], plain[i:i + 1])
        ctl = _distance(control[i:i + 1], plain[i:i + 1])
        assert 0 < ctl and err <= 2 * ctl, (name, err, ctl)
    again = _fwd_bwd(fa.fused_attention, q, k, v, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# (q shape, k / v shape, dtype): ragged lengths, grouped-query heads, the
# REDUCED config's head size 32, and float32 (the CUDA cores' form)
CARD_FORMS = [((3, 200, 8, 32), (3, 77, 2, 32), torch.bfloat16),
              ((2, 1, 4, 64), (2, 65, 2, 64), torch.bfloat16),
              ((2, 70, 4, 64), (2, 130, 4, 64), torch.float32),
              ((2, 33, 6, 32), (2, 95, 3, 32), torch.float32)]


@pytest.mark.card
@pytest.mark.parametrize("form", range(len(CARD_FORMS)))
def test_card_other_forms_match_the_chunk_loop(card, form):
    """bfloat16 within twice a one-ulp rounding control of the loop;
    float32 within 1e-5 of each output's largest element (``__expf`` is
    off by up to 2 + 1.2 |x| ulp, the loop's sums run in another order),
    and two runs equal bit for bit."""
    qs, ks, dtype = CARD_FORMS[form]
    q, k, v = _qkv(qs, ks, dtype, seed=20 + form, device=card)
    do = torch.randn(qs, generator=torch.Generator().manual_seed(8)).to(
        device=card, dtype=dtype)
    got = _fwd_bwd(fa.fused_attention, q, k, v, do)
    plain = _fwd_bwd(_loop, q, k, v, do)
    control = _fwd_bwd(_loop, *(_nudged(t, 31 + i) for i, t in
                                enumerate((q, k, v, do))))
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        assert got[i].dtype == dtype and got[i].shape == plain[i].shape
        err = _distance(got[i:i + 1], plain[i:i + 1])
        if dtype == torch.float32:
            tol = 1e-5 * plain[i].abs().max().item()
        else:
            tol = 2 * _distance(control[i:i + 1], plain[i:i + 1])
            assert tol > 0
        assert err <= tol, (name, err, tol)
    again = _fwd_bwd(fa.fused_attention, q, k, v, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.card
def test_card_whisper_step_matches_the_chunk_loop(card, monkeypatch):
    """whisper-small at full size, bfloat16, one ``vmap`` chunk of the
    benchmark's step (5 workers of batch 4 x 128 tokens) through
    ``grad_and_value`` with remat: losses and grads within twice a
    one-ulp rounding control of the chunk loop's, 48 forward and 24
    backward launches, the same bits twice."""
    cfg = get_config("whisper_small")
    params, batch = _whisper_inputs(cfg, 5, 4, 128, seed=4, device=card)
    fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    g1, l1 = _whisper_grads(cfg, params, batch)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (48, 24)
    g2, l2 = _whisper_grads(cfg, params, batch)
    assert torch.equal(l1, l2) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g2)))
    monkeypatch.setattr(attention, "fused_attention", _loop)
    g0, l0 = _whisper_grads(cfg, params, batch)
    seeds = iter(range(100, 10_000))
    gc, lc = _whisper_grads(cfg, tree_map(
        lambda t: _nudged(t, next(seeds)), params), batch)
    assert fa.LAUNCHES == 96
    err = (_distance([l1], [l0]), _distance(tree_leaves(g1), tree_leaves(g0)))
    ctl = (_distance([lc], [l0]), _distance(tree_leaves(gc), tree_leaves(g0)))
    assert all(0 < c and e <= 2 * c for e, c in zip(err, ctl)), (err, ctl)
