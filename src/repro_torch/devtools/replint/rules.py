"""The six replint rules, the port's copy (DESIGN.md §13).

Each rule is a function over a :class:`~repro_torch.devtools.replint.core.FileContext`
yielding findings; registration order is report order. All analysis is
purely syntactic (stdlib ``ast``) — rules prefer false positives that a
``# replint: ok(<rule>)`` pragma can document over silent false
negatives, because every invariant here was violated at least once in a
merged PR before being caught by hand.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.devtools.replint.core import FileContext, Finding, register

# --------------------------------------------------------------------------
# shared helpers


def _dotted(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``a.b.c`` attribute chain as a tuple, or None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _is_setish(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset"))


def _self_attr(node: ast.AST) -> Optional[str]:
    """Attribute name when ``node`` is ``self.<attr>``, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


# --------------------------------------------------------------------------
# determinism


_WALLCLOCK = {"time", "monotonic", "perf_counter", "process_time",
              "time_ns", "monotonic_ns", "perf_counter_ns"}
_DATETIME_FNS = {"now", "utcnow", "today"}
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "MT19937", "BitGenerator", "RandomState"}
_RANDOM_OK = {"Random", "SystemRandom"}


@register("determinism",
          "no wall clocks, global RNG, id() keys, or set-iteration-order "
          "dependence in repro_torch/net and repro_torch/runtime")
def check_determinism(ctx: FileContext) -> Iterable[Finding]:
    if not ctx.in_package_dirs(("net", "runtime")):
        return
    tree = ctx.tree

    # import aliasing: local name -> dotted module it refers to
    modmap: Dict[str, str] = {}
    from_random: Set[str] = set()
    from_time: Set[str] = set()
    np_default_rng_aliases: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                modmap[alias.asname or alias.name.split(".")[0]] = \
                    alias.name if alias.asname else alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            for alias in node.names:
                local = alias.asname or alias.name
                if mod == "random" and alias.name not in _RANDOM_OK:
                    from_random.add(local)
                elif mod == "time" and alias.name in _WALLCLOCK:
                    from_time.add(local)
                elif mod == "numpy.random" and alias.name == "default_rng":
                    np_default_rng_aliases.add(local)

    def flag(node: ast.AST, msg: str) -> Finding:
        return Finding("determinism", ctx.path, node.lineno,
                       node.col_offset, msg)

    # class attrs assigned set-typed values (self.x = set(...)/{...}/frozenset)
    class_set_attrs: Dict[ast.ClassDef, Set[str]] = {}
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        attrs: Set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and _is_setish(node.value):
                for tgt in node.targets:
                    a = _self_attr(tgt)
                    if a:
                        attrs.add(a)
            elif isinstance(node, ast.AnnAssign) and node.value is not None \
                    and _is_setish(node.value):
                a = _self_attr(node.target)
                if a:
                    attrs.add(a)
        # class-level declarations like ``active: frozenset = frozenset()``
        for stmt in cls.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name) and \
                    stmt.value is not None and _is_setish(stmt.value):
                attrs.add(stmt.target.id)
            elif isinstance(stmt, ast.Assign) and _is_setish(stmt.value):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        attrs.add(tgt.id)
        class_set_attrs[cls] = attrs

    # inherit set-typed attrs from same-file base classes (fixpoint over
    # the local class graph: subclasses iterate what the base assigns)
    by_name = {cls.name: cls for cls in class_set_attrs}
    changed = True
    while changed:
        changed = False
        for cls, attrs in class_set_attrs.items():
            for base in cls.bases:
                bcls = by_name.get(base.id) \
                    if isinstance(base, ast.Name) else None
                if bcls is not None and not \
                        class_set_attrs[bcls] <= attrs:
                    attrs.update(class_set_attrs[bcls])
                    changed = True

    # map every node to its nearest enclosing class (for self.attr lookup)
    owner: Dict[int, ast.ClassDef] = {}
    for cls in class_set_attrs:
        for node in ast.walk(cls):
            owner.setdefault(id(node), cls)

    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            findings.extend(_det_check_call(
                node, ctx, modmap, from_random, from_time,
                np_default_rng_aliases))

    # comprehensions consumed by order-insensitive reductions are fine:
    # sorted(x for x in s), max(...), any(...) do not depend on order
    order_free_comps: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("sorted", "min", "max", "sum", "any",
                                     "all", "len", "set", "frozenset"):
            for arg in node.args:
                if isinstance(arg, _COMP_NODES):
                    order_free_comps.add(id(arg))

    # set-iteration-order dependence
    for fn in [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        local_sets: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _is_setish(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        local_sets.add(tgt.id)
        sites: List[ast.expr] = []
        for node in ast.walk(fn):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                sites.append(node.iter)
            elif isinstance(node, _COMP_NODES) \
                    and id(node) not in order_free_comps:
                sites.extend(gen.iter for gen in node.generators)
        for it in sites:
            if _is_setish(it):
                findings.append(flag(
                    it, "iteration over a set expression: order is hash- "
                        "and history-dependent; sort it (or iterate an "
                        "ordered container) to keep replays bitwise"))
                continue
            a = _self_attr(it)
            cls = owner.get(id(fn))
            if a and cls is not None and a in class_set_attrs.get(cls, ()):
                findings.append(flag(
                    it, f"iteration over set attribute 'self.{a}': order "
                        f"is hash- and history-dependent; iterate "
                        f"sorted(self.{a}) to keep replays bitwise"))
            elif isinstance(it, ast.Name) and it.id in local_sets:
                findings.append(flag(
                    it, f"iteration over local set {it.id!r}: order is "
                        f"hash- and history-dependent; sort it to keep "
                        f"replays bitwise"))

    # deduplicate (nested walks can visit a node twice)
    seen: Set[Tuple[int, int, str]] = set()
    for f in findings:
        key = (f.line, f.col, f.message)
        if key not in seen:
            seen.add(key)
            yield f


def _det_check_call(node: ast.Call, ctx: FileContext, modmap: Dict[str, str],
                    from_random: Set[str], from_time: Set[str],
                    np_rng_aliases: Set[str]) -> Iterator[Finding]:
    def flag(msg: str) -> Finding:
        return Finding("determinism", ctx.path, node.lineno,
                       node.col_offset, msg)

    func = node.func
    if isinstance(func, ast.Name):
        if func.id == "id":
            yield flag("id() is address-dependent and varies across "
                       "processes; key on a stable identity instead")
        elif func.id in from_random:
            yield flag(f"global random.{func.id}() draws from shared "
                       f"process state; use a seeded random.Random / "
                       f"np.random.default_rng(seed)")
        elif func.id in from_time:
            yield flag(f"wall-clock {func.id}() in sim code; use sim.now")
        elif func.id in np_rng_aliases and not node.args and not node.keywords:
            yield flag("unseeded default_rng(): pass an explicit seed")
        return

    chain = _dotted(func)
    if not chain:
        return
    root = modmap.get(chain[0])
    resolved = (root,) + chain[1:] if root else chain
    if root == "time" and len(resolved) == 2 and resolved[1] in _WALLCLOCK:
        yield flag(f"wall-clock time.{resolved[1]}() in sim code; "
                   f"use sim.now")
    elif resolved[-1] in _DATETIME_FNS and any(
            p in ("datetime", "date") for p in resolved[:-1]):
        yield flag(f"wall-clock datetime {resolved[-1]}() in sim code; "
                   f"use sim.now")
    elif root == "random" and len(resolved) == 2 \
            and resolved[1] not in _RANDOM_OK:
        yield flag(f"global random.{resolved[1]}() draws from shared "
                   f"process state; use a seeded random.Random / "
                   f"np.random.default_rng(seed)")
    elif root == "numpy" and len(resolved) >= 3 and resolved[1] == "random":
        attr = resolved[2]
        if attr not in _NP_RANDOM_OK:
            yield flag(f"legacy global np.random.{attr}(): use a seeded "
                       f"np.random.default_rng(seed) Generator")
        elif attr == "default_rng" and len(resolved) == 3 \
                and not node.args and not node.keywords:
            yield flag("unseeded np.random.default_rng(): pass an "
                       "explicit seed")


# --------------------------------------------------------------------------
# pool-reset


_CONTAINER_CTORS = {"list", "dict", "set", "frozenset", "deque",
                    "defaultdict", "OrderedDict", "Counter", "bytearray"}
_MUTATORS = {"clear", "update", "extend", "append", "appendleft", "pop",
             "popleft", "add", "discard", "remove", "insert", "setdefault"}


def _init_candidates(init: ast.FunctionDef) -> Dict[str, int]:
    """Mutable-state attrs ``__init__`` creates, attr -> first line.

    An attr is pool-state (must be re-initialized by ``reset``) when its
    value is a constant or a container built without referencing any
    ``__init__`` parameter; anything wired from the constructor args is
    configuration, not per-life state.
    """
    params: Set[str] = set()
    a = init.args
    for arg in [*a.posonlyargs, *a.args, *a.kwonlyargs]:
        params.add(arg.arg)
    if a.vararg:
        params.add(a.vararg.arg)
    if a.kwarg:
        params.add(a.kwarg.arg)
    params.discard("self")

    def refs_param(expr: ast.AST) -> bool:
        return any(isinstance(n, ast.Name) and n.id in params
                   for n in ast.walk(expr))

    def resettable(expr: ast.AST) -> bool:
        if isinstance(expr, ast.Constant):
            return True
        if isinstance(expr, ast.UnaryOp) and \
                isinstance(expr.operand, ast.Constant):
            return True
        if isinstance(expr, (ast.List, ast.Tuple, ast.Dict, ast.Set,
                             ast.ListComp, ast.SetComp, ast.DictComp)):
            return True
        if isinstance(expr, ast.Call):
            chain = _dotted(expr.func)
            return bool(chain) and chain[-1] in _CONTAINER_CTORS
        return False

    out: Dict[str, int] = {}
    for node in ast.walk(init):
        targets: List[Tuple[ast.AST, ast.AST]] = []
        if isinstance(node, ast.Assign):
            targets = [(t, node.value) for t in node.targets]
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [(node.target, node.value)]
        for tgt, value in targets:
            attr = _self_attr(tgt)
            if attr and attr not in out and not refs_param(value) \
                    and resettable(value):
                out[attr] = tgt.lineno
    return out


def _reset_covered(cls_methods: Dict[str, ast.FunctionDef]) -> Set[str]:
    """Attrs re-initialized by ``reset`` or any self-method it calls."""
    covered: Set[str] = set()
    queue = ["reset"]
    visited: Set[str] = set()
    while queue:
        name = queue.pop()
        if name in visited or name not in cls_methods:
            continue
        visited.add(name)
        for node in ast.walk(cls_methods[name]):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    a = _self_attr(tgt)
                    if a:
                        covered.add(a)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                a = _self_attr(node.target)
                if a:
                    covered.add(a)
            elif isinstance(node, ast.Delete):
                for tgt in node.targets:
                    a = _self_attr(tgt)
                    if a:
                        covered.add(a)
            elif isinstance(node, ast.Call):
                chain = _dotted(node.func)
                if chain and chain[0] == "self":
                    if len(chain) == 2 and chain[1] in cls_methods:
                        queue.append(chain[1])
                    elif len(chain) == 3 and chain[2] in _MUTATORS:
                        covered.add(chain[1])
    return covered


@register("pool-reset",
          "classes implementing the pooling reset() protocol must reset "
          "every mutable attribute __init__ creates")
def check_pool_reset(ctx: FileContext) -> Iterable[Finding]:
    for cls in [n for n in ast.walk(ctx.tree)
                if isinstance(n, ast.ClassDef)]:
        methods = {s.name: s for s in cls.body
                   if isinstance(s, ast.FunctionDef)}
        if "__init__" not in methods or "reset" not in methods:
            continue
        candidates = _init_candidates(methods["__init__"])
        covered = _reset_covered(methods)
        for attr, line in sorted(candidates.items(), key=lambda kv: kv[1]):
            if attr not in covered:
                yield Finding(
                    "pool-reset", ctx.path, line, 0,
                    f"{cls.name}.__init__ makes mutable state "
                    f"'self.{attr}' but reset() never re-initializes it; "
                    f"a pooled reuse would leak the previous life's state")


# --------------------------------------------------------------------------
# gen-fence


_FENCE_TOKENS = {"_ps_epoch", "_flight", "epoch", "gen", "stopped",
                 "_stopped", "closed", "done", "dead", "alive", "_ps_down"}
_REGISTER_ATTRS = {"at", "after", "send", "send_train"}


def _has_fence(fn: ast.AST) -> bool:
    """A closure is considered guarded when it references generation /
    epoch / liveness state, or pops a registry entry."""
    body = fn.body if isinstance(fn, ast.Lambda) else fn
    for node in ast.walk(body if isinstance(body, ast.AST) else fn):
        if isinstance(node, ast.Name) and node.id in _FENCE_TOKENS:
            return True
        if isinstance(node, ast.Attribute) and node.attr in _FENCE_TOKENS:
            return True
        if isinstance(node, ast.Call):
            chain = _dotted(node.func)
            if chain and chain[-1] == "pop":
                return True
    return False


def _is_delegation(fn: ast.AST) -> bool:
    """A lambda/def whose whole body is one call forwards to a method
    that carries its own guard — allowed."""
    if isinstance(fn, ast.Lambda):
        return isinstance(fn.body, ast.Call)
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        body = [s for s in fn.body
                if not (isinstance(s, ast.Expr)
                        and isinstance(s.value, ast.Constant))]
        return len(body) == 1 and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Call)
    return False


@register("gen-fence",
          "meta['g'] only through repro_torch.net.genfence; "
          "sim-registered closures in repro_torch/runtime carry a "
          "staleness guard")
def check_gen_fence(ctx: FileContext) -> Iterable[Finding]:
    in_net_rt = ctx.in_package_dirs(("net", "runtime"))
    if not in_net_rt or ctx.filename == "genfence.py":
        return
    # f-string format specs (``f"{x:g}"``) carry a Constant "g" that has
    # nothing to do with the generation key
    in_fstring: Set[int] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.JoinedStr):
            for sub in ast.walk(node):
                in_fstring.add(id(sub))
    # (a) raw "g" meta key anywhere outside the sanctioned helpers
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Constant) and node.value == "g" \
                and id(node) not in in_fstring:
            yield Finding(
                "gen-fence", ctx.path, node.lineno, node.col_offset,
                "raw 'g' generation key; use repro_torch.net.genfence "
                "(GEN_KEY / gen_of / is_stale) so every fence "
                "read/write shares one code path")

    # (b) runtime-layer closures registered on the sim / a transport
    if not ctx.in_package_dirs(("runtime",)):
        return
    for outer in [n for n in ast.walk(ctx.tree)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        local_defs = {n.name: n for n in ast.walk(outer)
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                      and n is not outer}
        for call in [n for n in ast.walk(outer) if isinstance(n, ast.Call)]:
            func = call.func
            if not isinstance(func, ast.Attribute) \
                    or func.attr not in _REGISTER_ATTRS:
                continue
            if func.attr in ("at", "after"):
                base = _dotted(func.value)
                if not base or base[-1] != "sim":
                    continue
            cb_args = list(call.args) + [kw.value for kw in call.keywords]
            for arg in cb_args:
                target: Optional[ast.AST] = None
                label = "<lambda>"
                if isinstance(arg, ast.Lambda):
                    target = arg
                elif isinstance(arg, ast.Name) and arg.id in local_defs:
                    target = local_defs[arg.id]
                    label = arg.id
                if target is None:
                    continue
                if _is_delegation(target) or _has_fence(target):
                    continue
                yield Finding(
                    "gen-fence", ctx.path, call.lineno, call.col_offset,
                    f"closure {label!r} registered on the sim/transport "
                    f"without a staleness guard: check a generation / "
                    f"epoch fence (or pop a flight-registry entry) before "
                    f"touching state, or delegate to a guarded method")


# --------------------------------------------------------------------------
# hotpath


_COMP_NODES = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def _tracker_guarded(test: ast.AST) -> bool:
    """True for ``if self._h_x is not None: ...`` style tracker arms —
    allocation there is off the bitwise-parity path by construction."""
    for n in ast.walk(test):
        if isinstance(n, ast.Attribute) and (
                "tracker" in n.attr or n.attr.startswith(("_h_", "_g_"))):
            return True
        if isinstance(n, ast.Name) and (
                "tracker" in n.id or n.id.startswith("_h_")):
            return True
    return False


def _hot_violations(fn: ast.AST, ctx: FileContext,
                    out: List[Finding]) -> None:
    def visit(node: ast.AST) -> None:
        if isinstance(node, ast.If) and _tracker_guarded(node.test):
            for s in node.orelse:
                visit(s)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not fn:
            out.append(Finding(
                "hotpath", ctx.path, node.lineno, node.col_offset,
                f"hot path defines closure {node.name!r} per call; "
                f"pre-bind it (functools.partial / default args)"))
            return
        if isinstance(node, ast.Lambda):
            out.append(Finding(
                "hotpath", ctx.path, node.lineno, node.col_offset,
                "hot path allocates a lambda per call; pre-bind it "
                "(functools.partial / default args)"))
            return
        if isinstance(node, _COMP_NODES):
            out.append(Finding(
                "hotpath", ctx.path, node.lineno, node.col_offset,
                "hot path builds a comprehension per call; hoist the "
                "allocation or loop in place"))
            return
        if isinstance(node, ast.JoinedStr):
            out.append(Finding(
                "hotpath", ctx.path, node.lineno, node.col_offset,
                "hot path formats an f-string per call off the tracker "
                "arm; move formatting behind the tracker guard"))
            return
        for child in ast.iter_child_nodes(node):
            visit(child)

    for stmt in fn.body:
        visit(stmt)


@register("hotpath",
          "functions marked '# replint: hotpath' may not allocate "
          "closures, comprehensions, or f-strings off the tracker arm")
def check_hotpath(ctx: FileContext) -> Iterable[Finding]:
    hot = ctx.pragmas.hotpath_lines
    if not hot:
        return
    out: List[Finding] = []
    for fn in [n for n in ast.walk(ctx.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        lines = {fn.lineno} | {d.lineno for d in fn.decorator_list}
        if lines & hot:
            _hot_violations(fn, ctx, out)
    yield from out


# --------------------------------------------------------------------------
# frozen-config


_UNHASHABLE = {"List", "Dict", "Set", "DefaultDict", "Deque", "Counter",
               "MutableMapping", "MutableSequence", "MutableSet",
               "list", "dict", "set", "deque", "defaultdict", "bytearray",
               "ndarray"}


def _is_frozen_dataclass(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        if isinstance(dec, ast.Call):
            chain = _dotted(dec.func)
            if chain and chain[-1] == "dataclass":
                for kw in dec.keywords:
                    if kw.arg == "frozen" and \
                            isinstance(kw.value, ast.Constant) and \
                            kw.value.value is True:
                        return True
    return False


@register("frozen-config",
          "frozen dataclasses in config.py must have recursively "
          "hashable field types")
def check_frozen_config(ctx: FileContext) -> Iterable[Finding]:
    if ctx.filename != "config.py":
        return
    for cls in [n for n in ast.walk(ctx.tree)
                if isinstance(n, ast.ClassDef)]:
        if not _is_frozen_dataclass(cls):
            continue
        for stmt in cls.body:
            if not isinstance(stmt, ast.AnnAssign):
                continue
            ann: ast.AST = stmt.annotation
            if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                try:
                    ann = ast.parse(ann.value, mode="eval").body
                except SyntaxError:
                    continue
            for node in ast.walk(ann):
                name = None
                if isinstance(node, ast.Name):
                    name = node.id
                elif isinstance(node, ast.Attribute):
                    name = node.attr
                if name in _UNHASHABLE:
                    field = stmt.target.id \
                        if isinstance(stmt.target, ast.Name) else "?"
                    yield Finding(
                        "frozen-config", ctx.path, stmt.lineno,
                        stmt.col_offset,
                        f"frozen dataclass {cls.name}.{field} is typed "
                        f"{name}: unhashable fields break configs used "
                        f"as cache keys; use a tuple / frozen type")
                    break


# --------------------------------------------------------------------------
# design-ref


_CITE_RE = re.compile(r"DESIGN\.md\s*§\s*([A-Za-z0-9_]+(?:\.[0-9]+)*)")


@register("design-ref",
          "every §N citation into DESIGN.md resolves to a real section "
          "heading")
def check_design_ref(ctx: FileContext) -> Iterable[Finding]:
    sections = ctx.design_sections
    if sections is None:
        return  # no DESIGN.md governs this file (e.g. bare fixtures)
    for lineno, line in enumerate(ctx.lines, start=1):
        for m in _CITE_RE.finditer(line):
            token = m.group(1)
            if token not in sections:
                yield Finding(
                    "design-ref", ctx.path, lineno, m.start(),
                    f"citation 'DESIGN.md §{token}' does not resolve to "
                    f"any DESIGN.md section heading")
