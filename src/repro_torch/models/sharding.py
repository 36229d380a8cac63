"""Sharding rules for params: the name-based 2D specs.

The PyTorch counterpart of the JAX package's ``models/sharding.py``
(baseline scheme, DESIGN.md §4: 2D "fsdp + tensor" sharding):

  - ``data`` axis: FSDP shard of weight matrices + batch parallelism.
  - ``model`` axis: tensor parallelism (heads / d_ff / experts / vocab).
  - ``pod`` axis (multi-pod only): pure data parallelism across pods;
    weights are replicated across pods, so the only cross-pod traffic is
    the gradient all-reduce, the "PS over WAN/DCN" link LTP targets.

Rules are name-based: parameter tree paths carry conventional leaf names
(``wq``, ``w_up``, ``embed``, ...). ``spec_for(path, shape, mesh)``
returns a spec; dims that do not divide the mesh axis stay replicated.

A spec is a plain tuple with one entry a dim: ``None`` (replicated), an
axis name, or a tuple of axis names; ``()`` is fully replicated, as
``PartitionSpec()`` is. A mesh is anything with axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh``, or a plain ``{name: size}``
dict, so the specs of the production meshes, (16, 16) and (2, 16, 16),
are computed with no process group.

Tensor parallelism over ``model`` (the counterpart of the reference's
``ShardCtx`` and the GSPMD partitioning its constraints drive): a rank
holds its block of every leaf that ``model_specs`` shards and the model
code (``layers``, ``attention``, ``mla``, ``moe``, ``ssm``,
``transformer``, ``encdec``) computes with those blocks, Megatron-style,
through the differentiable collectives below on the ``model`` process
group: ``copy_in`` (identity forward, all-reduce backward) at the entry
of a column-parallel block, ``reduce_out`` (all-reduce forward, identity
backward) after a row-parallel one, ``row_parallel`` (a row-parallel
product through ``reduce_out``, its partial products summed in float32
and rounded once), ``reduce_both`` (all-reduce both ways), ``gather``
(all-gather forward, this rank's block backward),
``reblock`` (a column-parallel output regrouped by all-to-all),
``cols_to_rows`` (the tied table's reshard), and ``rows_of`` /
``cols_of`` (this rank's block of a replicated leaf). Activations
between blocks are replicated over ``model``. ``ShardCtx`` carries the
mesh and the group; ``None`` (every call without a model axis) means no
collective at all. The CNN computes whole on every rank: its layout
splits nothing.

Two of these collectives are right only where they are used:

- ``gather``'s backward takes this rank's block of the gradient. That
  holds when every rank uses the gathered tensor alike (replicated
  computation). A tensor gathered and then used differently on each
  rank (a weight gathered and sliced) needs a reduce-scatter backward:
  ``reblock``'s gathered segments have one.
- ``reduce_out``'s backward passes the gradient unchanged. That holds
  when what follows runs replicated. A sum over ``model`` that then
  feeds code split over ``model`` gets only this rank's share of its
  gradient back, and needs ``reduce_both``: Mamba-1's ``x_proj`` output
  (its input is split over channels, its output feeds the channel-split
  ``dt_proj`` and scan) and the mean of squares of Mamba-2's gated
  RMSNorm (over the whole ``d_inner``, applied per head block).

The layout is ``spec_for(..., fsdp=False)`` on the ``model`` axis, taken
of one period's leaf for a leaf stacked over the periods or layers
(``stack``, and the enc-dec's ``enc_stack`` and ``dec_stack``: its
leading axis is the stack's, which ``spec_for`` would take for a weight
dim), with two exceptions:

- the heads: ``wq``, ``wk``, ``wv`` and ``wo`` (and MLA's ``w_uq``,
  ``w_uk`` and ``w_uv``) stay replicated unless both ``n_heads`` and
  ``n_kv`` divide the axis, and the attention then runs replicated on
  every rank. ``spec_for`` shards them whenever ``H * hd`` or ``KV * hd``
  divides, which would split a head (or a query head from its KV head)
  across ranks; the reference's fallback for such heads
  (``_constrain_heads``) computes the same numbers, on sequence shards
  instead;
- the SSM channels: ``in_proj``, ``out_proj`` and ``dt_proj`` stay
  replicated unless the mixer splits whole (Mamba-1: ``d_inner``
  divides; Mamba-2: ``ssm_heads`` and ``in_proj``'s width divide), and
  the mixer then runs replicated. Where they split, ``in_proj``'s
  contiguous column block is not this rank's channels: its columns are
  ``[x | z]`` (Mamba-1) or ``[z | x | B | C | dt]`` (Mamba-2), so at
  ``model`` = 2 rank 0 holds all of Mamba-1's ``x`` and rank 1 all of
  its ``z``. The leaf keeps ``spec_for``'s block (``shard_params``,
  ``gather_params`` and the gate's global view stay as they are) and
  the model ``reblock``s the projection's output instead: an all-to-all
  leaves rank r with its channels of each split segment and the whole
  of ``B`` and ``C``.

``moe_gate`` (the router), the norm scales and every 1-D leaf are
replicated, as ``spec_for`` says.

FSDP over ``data`` (the reference's plain step under ``spec_for(...,
fsdp=True)``): ``fsdp_specs`` adds a ``data`` dim to the ``model``
layout, ``shard_params`` / ``gather_params`` take both axes, and the
model code, given an ``FsdpCtx``, gathers each leaf's ``data`` blocks
where it uses it (``whole``: all-gather forward, reduce-scatter of the
gradient backward, since each data rank uses the leaf on its own block
of the batch).

Not carried over: ``param_shardings`` (``NamedSharding`` trees): a
rank's block is a plain tensor (``shard_params``).
"""
from __future__ import annotations

import functools
import warnings
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map_with_path

Spec = Tuple[Any, ...]


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a plain dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh without mesh_dim_names has no axes "
                         "to shard over")
    return {n: int(s) for n, s in zip(names, mesh.shape)}


def axis_names(mesh: Any) -> Tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def dp_axes(mesh: Any) -> Tuple[str, ...]:
    """The batch-parallel axes present in this mesh ((pod, data) or
    (data,))."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh: Any, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _fits(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0


# Leaf-name -> (dim sharded over 'data', dim sharded over 'model').
# None means "never shard that side".
_RULES = {
    # embeddings / unembedding
    "embed": (1, 0),          # (vocab, d_model): vocab->model, d->data
    "lm_head": (0, 1),        # (d_model, vocab): vocab->model
    "pos_embed": (None, 1),   # (max_pos, d_model)
    # attention projections
    "wq": (0, 1),             # (d_model, H*hd)
    "wk": (0, 1),
    "wv": (0, 1),
    "wo": (1, 0),             # (H*hd, d_model)
    # MLA
    "w_dq": (0, None),        # (d, q_lora)
    "w_uq": (None, 1),        # (q_lora, H*qk_dim)
    "w_dkv": (0, None),       # (d, kv_lora + rope)
    "w_uk": (None, 1),        # (kv_lora, H*nope)
    "w_uv": (None, 1),        # (kv_lora, H*v_dim)
    # MLP
    "w_gate": (0, 1),         # (d, ff)
    "w_up": (0, 1),
    "w_down": (1, 0),         # (ff, d)
    # MoE (E, d, ff) / (E, ff, d): expert dim -> model when divisible,
    # handled specially in spec_for.
    "moe_gate": (0, None),    # router (d, E)
    # SSM
    "in_proj": (0, 1),        # (d, 2*d_inner) etc.
    "out_proj": (1, 0),       # (d_inner, d)
    "x_proj": (1, None),      # (d_inner, dt_rank + 2*state)
    "dt_proj": (None, 1),     # (dt_rank, d_inner)
    "conv_w": (1, None),      # (k, d_inner) tap-major
    "A_log": (1, None),       # (d_inner, state): model on d_inner
    # CNN
    "conv": (None, None),
    "fc": (0, None),
}

_REPLICATED_SUFFIXES = (
    "scale", "bias", "offset", "D", "dt_bias", "A_log_m2", "gamma",
)


def _leaf_name(path: Tuple[Any, ...]) -> str:
    """The last dict key of a path (``repro_torch.tree`` paths hold dict
    keys and list/tuple positions; the positions are skipped, as the
    reference skips ``SequenceKey``)."""
    keys = [p for p in path if isinstance(p, str)]
    return keys[-1] if keys else ""


def spec_for(path: Tuple[Any, ...], shape: Tuple[int, ...], mesh: Any, *,
             fsdp: bool = True) -> Spec:
    """Spec for one parameter leaf, honoring divisibility.

    ``fsdp=False`` drops the 'data' (FSDP) axis from weight specs: used
    when weights must be replicated across the worker axes (LTP's
    per-worker gradient masking on a single-pod mesh)."""
    name = _leaf_name(path)
    nd = axis_size(mesh, "data") if fsdp else 1
    nm = axis_size(mesh, "model")
    ndim = len(shape)

    if name in _REPLICATED_SUFFIXES or ndim <= 1:
        return ()

    if not fsdp and name == "embed" and ndim == 2:
        # inside manual (LTP) regions the token-lookup gather must be
        # shard-local: shard d_model, replicate vocab rows
        return (None, "model") if _fits(shape[1], nm) else ()

    # MoE expert stacks: (E, d_in, d_out)
    if name in ("experts_gate", "experts_up", "experts_down") and ndim == 3:
        e, di, _ = shape
        spec: list = [None, None, None]
        if _fits(e, nm):
            spec[0] = "model"
            if _fits(di, nd):
                spec[1] = "data"
        else:  # few big experts (mixtral): tensor-parallel within experts
            ff_dim = 2 if name != "experts_down" else 1
            if _fits(shape[ff_dim], nm):
                spec[ff_dim] = "model"
            other = 1 if ff_dim == 2 else 2
            if _fits(shape[other], nd):
                spec[other] = "data"
        return tuple(spec)

    rule = _RULES.get(name)
    if rule is None:
        # generic 2D matmul weight: fsdp on dim0, tensor on dim1 when
        # divisible
        rule = (0, 1) if ndim == 2 else (None, None)
    d_dim, m_dim = rule
    spec = [None] * ndim
    if m_dim is not None and m_dim < ndim and _fits(shape[m_dim], nm):
        spec[m_dim] = "model"
    if (
        d_dim is not None
        and d_dim < ndim
        and spec[d_dim] is None
        and _fits(shape[d_dim], nd)
    ):
        spec[d_dim] = "data"
    return tuple(spec)


def param_specs(params_shape: Any, mesh: Any, *,
                fsdp: bool = True) -> Any:
    """Tree of specs matching a params tree (tensors, meta tensors or
    anything with a ``shape``)."""
    return tree_map_with_path(
        lambda path, leaf: spec_for(path, tuple(leaf.shape), mesh,
                                    fsdp=fsdp),
        params_shape)


def spec_at(specs: Any, path: Tuple[Any, ...]) -> Optional[Spec]:
    """The spec at ``path`` of a spec tree (a spec is a tuple, so it
    cannot be told from a tree node by its type: it is found by the
    path of the params leaf it belongs to)."""
    node = specs
    for k in path:
        node = node[k]
    return node


# ----------------------------------------------------------------------------
# tensor parallelism over the model axis
# ----------------------------------------------------------------------------

_HEAD_LEAVES = ("wq", "wk", "wv", "wo", "w_uq", "w_uk", "w_uv")
_SSM_LEAVES = ("in_proj", "out_proj", "dt_proj")
# the trees whose leaves are stacked over periods (``transformer``) or
# layers (``encdec``)
_STACKS = ("stack", "enc_stack", "dec_stack")


def _names(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def axis_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dim of ``spec`` sharded over ``axis``, or ``None``."""
    for dim, entry in enumerate(spec):
        if axis in _names(entry):
            return dim
    return None


def model_dim(spec: Spec) -> Optional[int]:
    """The dim of ``spec`` sharded over ``model``, or ``None``."""
    return axis_dim(spec, "model")


def data_dim(spec: Spec) -> Optional[int]:
    """The dim of ``spec`` sharded over ``data`` (FSDP), or ``None``."""
    return axis_dim(spec, "data")


def segments_split(segments: Tuple[Tuple[int, bool], ...], nm: int) -> bool:
    """Whether a column-parallel output of ``segments`` ((width, split)
    in column order) splits whole over ``nm`` ranks: its width and every
    split segment divide (``reblock``)."""
    return (sum(w for w, _ in segments) % nm == 0
            and all(w % nm == 0 for w, split_ in segments if split_))


def model_specs(cfg: Any, params_shape: Any, mesh: Any) -> Any:
    """The model-axis layout the port's models compute with: a tree of
    specs over a GLOBAL params (shape-)tree (module docstring)."""
    nm = axis_size(mesh, "model")
    from repro_torch.models.ssm import tp_splits  # ssm imports this module
    heads = cfg.n_heads % nm == 0 and cfg.n_kv % nm == 0
    ssm = tp_splits(cfg, nm)

    def spec(path, leaf):
        name = _leaf_name(path)
        if (name in _HEAD_LEAVES and not heads
                or name in _SSM_LEAVES and not ssm):
            return ()
        lead = 1 if path[0] in _STACKS else 0   # the periods' axis
        s = spec_for(path, tuple(leaf.shape)[lead:], {"model": nm},
                     fsdp=False)
        return (None,) * lead + s if s else ()

    return tree_map_with_path(spec, params_shape)


def fsdp_specs(cfg: Any, params_shape: Any, mesh: Any) -> Any:
    """The plain step's layout under FSDP over ``data``: each leaf's
    ``model_specs`` dim, and a ``data`` dim where ``spec_for(...,
    fsdp=True)`` gives one that the model layout leaves unsplit; where
    it gives the dim the model layout splits (the ``embed`` table's
    ``d_model`` columns), the leaf's other dim, if ``data`` divides it.
    A stacked leaf takes one period's spec, as ``model_specs`` does;
    the reference's ``spec_for`` takes the periods' axis for a weight
    dim (ROADMAP §3). The replicated names and 1-D leaves get no
    ``data`` dim."""
    nd = axis_size(mesh, "data")
    sizes = {"data": nd, "model": axis_size(mesh, "model")}
    model = model_specs(cfg, params_shape, mesh)

    def spec(path, leaf):
        mspec = spec_at(model, path)
        lead = 1 if path[0] in _STACKS else 0
        shape = tuple(leaf.shape)
        if (nd == 1 or _leaf_name(path) in _REPLICATED_SUFFIXES
                or len(shape) - lead <= 1):
            return mspec
        m = model_dim(mspec)
        d = data_dim(spec_for(path, shape[lead:], sizes, fsdp=True))
        if d is not None:
            d += lead
        if d is not None and d == m:
            other = [i for i in (lead, lead + 1) if i != m]
            d = (other[0] if len(shape) - lead == 2
                 and _fits(shape[other[0]], nd) else None)
        if d is None:
            return mspec
        out = list(mspec or (None,) * len(shape))
        out[d] = "data"
        return tuple(out)

    return tree_map_with_path(spec, params_shape)


def cache_spec(cfg: Any, code: str, name: str, ndim: int, nm: int) -> Spec:
    """The ``model``-axis spec of a decode cache leaf: leaf ``name`` (of
    ``ndim`` dims) of a layer with mixer ``code`` (``"A"``, ``"W"``,
    ``"L"``, ``"M"``, ``"M2"``; ``"X"`` for the enc-dec's self and cross
    K/V, stacked over the layers), on ``nm`` model ranks; a leaf stacked
    over the periods (a prefill's ``stack``) has the same spec with one
    more leading dim. The cache follows the heads and channels its layer's
    projections split (Megatron-style):

    - K/V (``(B, S, KV, hd)``): the KV heads split where
      ``attention.heads_ctx`` splits the heads, else replicated;
    - MLA's ``ckv`` and ``krope``: replicated (the latents are computed
      whole on every rank);
    - Mamba-1's ``h`` ``(B, d_inner, n)`` and ``conv`` ``(B, k-1,
      d_inner)``: the channels split where ``ssm.ssm_ctx`` splits the
      mixer; Mamba-2's ``h`` ``(B, nh, hp, n)`` on its heads, and its
      ``conv`` ``(B, k-1, d_inner + 2n)`` on its last dim as ``reblock``
      lays it out: this rank's block of ``x``'s channels, then the whole
      of ``B`` and ``C`` (``cache_segments``).

    The reference shards a cache by a shape heuristic instead (the
    batch over the data axes, the largest dim that divides ``model``
    over ``model``: a KV cache's sequence dim), which GSPMD makes
    correct there."""
    spec = [None] * ndim
    if nm == 1 or code == "L":
        return ()
    if code in ("A", "W", "X"):   # the KV heads: the dim before ``hd``
        if cfg.n_heads % nm or cfg.n_kv % nm:
            return ()
        spec[ndim - 2] = "model"
        return tuple(spec)
    from repro_torch.models.ssm import tp_splits  # ssm imports this module
    if not tp_splits(cfg, nm):
        return ()
    spec[1 if name == "h" else ndim - 1] = "model"
    return tuple(spec)


def cache_segments(cfg: Any, code: str, name: str):
    """``((width, split), ...)`` of a cache leaf's ``model`` dim where a
    rank holds a block of some segments and the whole of others
    (Mamba-2's ``conv``: ``x``, then ``B`` and ``C``), else ``None``
    (a plain block)."""
    if code == "M2" and name == "conv":
        return ((cfg.d_inner, True), (2 * cfg.ssm_state, False))
    return None


def cache_zeros(cfg: Any, code: str, name: str, shape: Tuple[int, ...],
                dtype, device, nm: int = 1) -> torch.Tensor:
    """A zero cache leaf of GLOBAL ``shape``, or on ``nm`` model ranks
    this rank's block of it (``cache_spec``, ``cache_segments``)."""
    spec = cache_spec(cfg, code, name, len(shape), nm)
    return torch.zeros(local_shape(shape, spec, nm,
                                   cache_segments(cfg, code, name)),
                       dtype=dtype, device=device)


def local_shape(shape: Tuple[int, ...], spec: Spec, nm: int,
                segments=None) -> Tuple[int, ...]:
    """A rank's shape of a leaf of GLOBAL ``shape`` under ``spec`` (and
    ``segments``, ``cache_segments``) on ``nm`` model ranks."""
    dim = model_dim(spec)
    if dim is None:
        return tuple(shape)
    out = list(shape)
    out[dim] = (out[dim] // nm if segments is None else
                sum(w // nm if split_ else w for w, split_ in segments))
    return tuple(out)


def block_of(t: torch.Tensor, dim: int, n: int, idx: int) -> torch.Tensor:
    """Block ``idx`` of ``n`` equal blocks of ``t`` on ``dim`` (a view)."""
    size = t.shape[dim] // n
    return t.narrow(dim, idx * size, size)


def all_gather_dim(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The blocks of the ``n`` ranks of ``group`` concatenated on ``dim``
    in rank order (no autograd)."""
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    with warnings.catch_warnings():
        # torch 2.13 deprecates the name for all_gather_single, which
        # torch 2.11 lacks
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(t: torch.Tensor, group, n: int,
                       dim: int) -> torch.Tensor:
    """The sum of ``t`` over the ``n`` ranks of ``group``, of which this
    rank keeps its block on ``dim`` (no autograd)."""
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    with warnings.catch_warnings():
        # torch 2.13 deprecates the name for reduce_scatter_single, which
        # torch 2.11 lacks
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def _split_dims(spec: Spec, mesh: Any):
    """``[(dim, axis, size)]`` of each axis of size > 1 that ``spec``
    splits, outermost first."""
    return [(dim, a, axis_size(mesh, a)) for dim, entry in enumerate(spec)
            for a in _names(entry) if axis_size(mesh, a) > 1]


def shard_params(params: Any, specs: Any, mesh: Any) -> Any:
    """This rank's block of every leaf of the GLOBAL ``params`` that
    ``specs`` (``model_specs``, or ``fsdp_specs`` with ``data`` too)
    shards, as a copy (the global tree can be freed); other leaves as
    they are. ``specs`` ``None`` (a layout that splits nothing): the
    tree itself."""
    if specs is None:
        return params

    def take(path, leaf):
        split_ = _split_dims(spec_at(specs, path), mesh)
        for dim, a, n in split_:
            leaf = block_of(leaf, dim, n, mesh.get_local_rank(a))
        return leaf.clone() if split_ else leaf

    return tree_map_with_path(take, params)


def gather_params(params: Any, specs: Any, mesh: Any) -> Any:
    """The global tree from every rank's blocks (``shard_params``'s
    inverse); a collective: every rank of each axis group that ``specs``
    splits calls it."""
    if specs is None:
        return params

    def put(path, leaf):
        for dim, a, n in reversed(_split_dims(spec_at(specs, path), mesh)):
            leaf = all_gather_dim(leaf, mesh.get_group(a), n, dim)
        return leaf

    return tree_map_with_path(put, params)


class ShardCtx:
    """The ``model`` axis of a mesh as the model code sees it: the
    axis's size ``nm``, this rank's coordinate ``index`` on it and its
    process group. The batch-parallel axes are the port's worker axes,
    which the model code never reduces over."""

    def __init__(self, mesh: Any):
        self.nm = axis_size(mesh, "model")
        self.index = mesh.get_local_rank("model")
        self.group = mesh.get_group("model")

    def splits(self, n: int) -> bool:
        """Whether a dim of size ``n`` splits evenly over ``model``."""
        return n % self.nm == 0


def tp_ctx(mesh: Any) -> Optional[ShardCtx]:
    """A ``ShardCtx`` for a mesh whose ``model`` axis is larger than 1,
    else ``None``."""
    if mesh is None or axis_size(mesh, "model") == 1:
        return None
    return ShardCtx(mesh)


class FsdpCtx:
    """The ``data`` axis of a mesh under FSDP (the plain step's
    ``fsdp=True``): its size ``nd``, this rank's coordinate ``index`` on
    it, its process group, and ``specs``, the layout of the GLOBAL
    params (``fsdp_specs``). The model code gathers each leaf's ``data``
    blocks where it uses the leaf (``whole``); ``None`` means no FSDP."""

    def __init__(self, mesh: Any, specs: Any):
        self.nd = axis_size(mesh, "data")
        self.index = mesh.get_local_rank("data")
        self.group = mesh.get_group("data")
        self.specs = specs

    def dim(self, path: Tuple[Any, ...]) -> Optional[int]:
        """The ``data`` dim of the GLOBAL leaf at ``path``, or ``None``."""
        return data_dim(spec_at(self.specs, path))


def _unwrapped(t: torch.Tensor) -> torch.Tensor:
    """The plain tensor beneath ``torch.func``'s wrappers of ``t``."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(x, fsdp, dim):
        return all_gather_dim(x, fsdp.group, fsdp.nd, dim)

    @staticmethod
    def setup_context(fctx, inputs, output):
        _, fctx.fsdp, fctx.dim = inputs

    @staticmethod
    def backward(fctx, g):
        # each rank used the whole leaf on its own block of the batch:
        # the gradients summed over data, this rank's block kept. Gloo
        # copies a reduce-scatter's result into its output when the call
        # completes, which the grad transforms refuse for a tensor of
        # theirs, so the collective runs on the plain tensor beneath
        f = fctx.fsdp
        with torch._C._DisableFuncTorch():
            out = reduce_scatter_dim(_unwrapped(g), f.group, f.nd, fctx.dim)
        return out, None, None


def whole(fsdp: Optional[FsdpCtx], tree: Any, *prefix: Any,
          period: bool = False) -> Any:
    """``tree`` (the params subtree at ``prefix``; with ``period``, one
    period's slice of a stacked subtree) with each leaf that the layout
    splits over ``data`` all-gathered there: the forward all-gathers,
    the backward reduce-scatters the gradient (its sum over ``data``,
    this rank's block). With ``fsdp`` ``None``, ``tree`` itself."""
    if fsdp is None:
        return tree

    def put(path, x):
        dim = fsdp.dim(prefix + path)
        if dim is None:
            return x
        return _FsdpGather.apply(x, fsdp, dim - 1 if period else dim)

    return tree_map_with_path(put, tree)


def split(ctx: Optional[ShardCtx], n: int) -> Optional[ShardCtx]:
    """``ctx`` where a dim of size ``n`` is split over ``model``, else
    ``None`` (the part runs replicated)."""
    return ctx if ctx is not None and ctx.splits(n) else None


@functools.lru_cache(maxsize=None)
def _reblock_plan(segments: Tuple[Tuple[int, bool], ...], nm: int,
                  q: int):
    """Rank ``q``'s side of ``reblock``: the columns of its block that
    it sends, in the order it sends them (to rank 0 first), and the
    counts it sends to and receives from each rank. ``segments``: (width,
    split) in column order; rank r needs its block of every split
    segment and the whole of every other, in column order."""
    total = sum(w for w, _ in segments)
    size = total // nm

    def needs(r):
        out, start = [], 0
        for w, split_ in segments:
            lo, hi = ((start + r * (w // nm), start + (r + 1) * (w // nm))
                      if split_ else (start, start + w))
            out.extend(range(lo, hi))
            start += w
        return out

    def held(cols, owner):
        return [c - owner * size for c in cols
                if owner * size <= c < (owner + 1) * size]

    send = [held(needs(r), q) for r in range(nm)]
    recv = [len(held(needs(q), o)) for o in range(nm)]
    return (tuple(c for cols in send for c in cols),
            tuple(len(cols) for cols in send), tuple(recv))


@functools.lru_cache(maxsize=None)
def _reblock_cols(segments: Tuple[Tuple[int, bool], ...], nm: int, q: int,
                  device: torch.device) -> torch.Tensor:
    """``_reblock_plan``'s columns as an index tensor on ``device``, made
    once for each layout (not a host-to-device copy a call)."""
    idx = _reblock_plan(segments, nm, q)[0]
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def _all_to_all_last(x: torch.Tensor, ctx: ShardCtx, send, recv):
    """``x``'s last-dim columns, ``send[r]`` of them to rank r in rank
    order, exchanged for ``recv[r]`` columns from rank r (no autograd)."""
    xs = x.movedim(-1, 0).contiguous()
    out = xs.new_empty((sum(recv),) + tuple(xs.shape[1:]))
    dist.all_to_all_single(out, xs, output_split_sizes=list(recv),
                           input_split_sizes=list(send), group=ctx.group)
    return out.movedim(0, -1).contiguous()


def _reduced(t: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=ctx.group)
    return t


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(x, ctx):
        return x.view_as(x)

    @staticmethod
    def setup_context(fctx, inputs, output):
        fctx.tp = inputs[1]

    @staticmethod
    def backward(fctx, g):
        return _reduced(g, fctx.tp), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(x, ctx):
        return _reduced(x, ctx)

    @staticmethod
    def setup_context(fctx, inputs, output):
        pass

    @staticmethod
    def backward(fctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(x, ctx, dim):
        return all_gather_dim(x, ctx.group, ctx.nm, dim)

    @staticmethod
    def setup_context(fctx, inputs, output):
        _, fctx.tp, fctx.dim = inputs

    @staticmethod
    def backward(fctx, g):
        tp = fctx.tp
        g = block_of(g, fctx.dim, tp.nm, tp.index)
        return g.contiguous(), None, None


class _ColsToRows(torch.autograd.Function):
    @staticmethod
    def forward(x, ctx):
        full = all_gather_dim(x, ctx.group, ctx.nm, 1)
        return block_of(full, 0, ctx.nm, ctx.index).contiguous()

    @staticmethod
    def setup_context(fctx, inputs, output):
        fctx.tp = inputs[1]

    @staticmethod
    def backward(fctx, g):
        tp = fctx.tp
        full = all_gather_dim(g, tp.group, tp.nm, 0)
        return block_of(full, 1, tp.nm, tp.index).contiguous(), None


class _Reblock(torch.autograd.Function):
    @staticmethod
    def forward(x, ctx, segments):
        _, send, recv = _reblock_plan(segments, ctx.nm, ctx.index)
        cols = _reblock_cols(segments, ctx.nm, ctx.index, x.device)
        return _all_to_all_last(x.index_select(-1, cols), ctx, send, recv)

    @staticmethod
    def setup_context(fctx, inputs, output):
        x, fctx.tp, fctx.segments = inputs
        fctx.shape = x.shape

    @staticmethod
    def backward(fctx, g):
        tp = fctx.tp
        _, send, recv = _reblock_plan(fctx.segments, tp.nm, tp.index)
        back = _all_to_all_last(g, tp, recv, send)
        cols = _reblock_cols(fctx.segments, tp.nm, tp.index, g.device)
        # a column sent to several ranks (a gathered segment) sums their
        # gradients: the reduce-scatter half
        return (g.new_zeros(fctx.shape).index_add(-1, cols, back), None,
                None)


class _AllMax(torch.autograd.Function):
    @staticmethod
    def forward(x, ctx):
        t = x.contiguous().clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=ctx.group)
        return t

    @staticmethod
    def setup_context(fctx, inputs, output):
        fctx.mark_non_differentiable(output)

    @staticmethod
    def backward(fctx, g):
        return None, None


def copy_in(x: torch.Tensor, ctx: Optional[ShardCtx]) -> torch.Tensor:
    """A replicated tensor entering a parallel block: the identity
    forward, its gradient summed over ``model`` backward."""
    return x if ctx is None else _CopyIn.apply(x, ctx)


def reduce_out(x: torch.Tensor, ctx: Optional[ShardCtx]) -> torch.Tensor:
    """The partial results of a parallel block summed over ``model``;
    the gradient passes unchanged."""
    return x if ctx is None else _ReduceOut.apply(x, ctx)


def reduce_both(x: torch.Tensor, ctx: Optional[ShardCtx]) -> torch.Tensor:
    """``reduce_out`` followed by ``copy_in``: partial sums summed over
    ``model``, and their gradient summed too, for a sum that feeds code
    split over ``model`` (module docstring)."""
    return copy_in(reduce_out(x, ctx), ctx)


def row_parallel(x: torch.Tensor, w: torch.Tensor, ctx: Optional[ShardCtx],
                 reduce=None) -> torch.Tensor:
    """``x @ w`` of a row-parallel block: under ``ctx`` ``x`` holds this
    rank's block of the contracted dim and ``w`` its rows. The partial
    products are taken in float32, summed over ``model`` and rounded
    once to ``x``'s dtype, as the whole product is, and as the
    reference's partitioned product reads on a (2, 2) mesh: bfloat16
    partial sums rounded before the sum round twice, which moves a
    bfloat16 model off its unsharded result by enough to flip a MoE
    router's near-ties (``tests/test_torch_trainer_13e.py``). A float32
    block computes as before. ``reduce``: the sum, ``reduce_out`` unless
    given (``reduce_both`` where the sum feeds code split over
    ``model``)."""
    if ctx is None:
        return x @ w
    return (reduce or reduce_out)(x.float() @ w.float(), ctx).to(x.dtype)


def reblock(x: torch.Tensor, ctx: Optional[ShardCtx],
            segments: Tuple[Tuple[int, bool], ...]) -> torch.Tensor:
    """A column-parallel output regrouped: ``x`` is this rank's block of
    contiguous columns of an output whose columns are ``segments``
    ((width, split) in order); the result holds this rank's block of
    each split segment and the whole of each other, in column order, by
    one all-to-all. Backward, the inverse all-to-all, the gradients of
    a whole segment summed over the ranks that took it."""
    if ctx is None:
        return x
    return _Reblock.apply(x, ctx, tuple(segments))


def gather(x: torch.Tensor, ctx: Optional[ShardCtx],
           dim: int) -> torch.Tensor:
    """Every rank's block of ``x`` concatenated on ``dim``; backward,
    this rank's block of the gradient."""
    return x if ctx is None else _Gather.apply(x, ctx, dim % x.ndim)


def cols_to_rows(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """A table split on its columns (dim 1) resharded to this rank's
    block of rows (dim 0), and back for the gradient: the reference's
    tied-embedding reshard (``src/repro/models/layers.py:150-159``)."""
    return _ColsToRows.apply(x, ctx)


def rows_of(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """This rank's block of rows of a replicated table used inside a
    parallel block (its gradient summed over ``model``)."""
    return block_of(copy_in(x, ctx), 0, ctx.nm, ctx.index)


def cols_of(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """This rank's block of the last dim of a replicated leaf used inside
    a parallel block (its gradient summed over ``model``): a per-channel
    leaf such as a conv's ``(k, C)`` taps or a ``(C,)`` bias."""
    return block_of(copy_in(x, ctx), -1, ctx.nm, ctx.index)


def all_max(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The elementwise maximum over ``model``, a constant for autograd
    (a logsumexp's shift)."""
    return _AllMax.apply(x, ctx)
