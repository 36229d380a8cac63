"""replint core: pragma parsing, rule registry, file walking.

A *rule* is a callable over a :class:`FileContext` yielding
:class:`Finding` objects. Rules register themselves with
:func:`register`; :func:`lint_file` runs the selected rules, applies
``# replint: ok(<rule>)`` suppressions, and reports pragma hygiene
(malformed pragmas, pragmas naming unknown rules, pragmas that
suppressed nothing) under the always-on pseudo-rule ``pragma``.
Unparsable files surface under the pseudo-rule ``parse``.

Pragma grammar (one directive per comment)::

    # replint: ok(rule)            suppress `rule` on this line
    # replint: ok(rule-a, rule-b)  suppress several rules
    # replint: hotpath             mark the next/this-line function hot
    # replint-torch: ok(rule)      the same, read by this copy only

A pragma comment on its own line applies to the next code line, so it
can sit above the statement it excuses; a trailing pragma applies to
its own line.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

#: ``replint-torch:`` is this copy's own form, unseen by the JAX copy
#: (see the package docstring)
PRAGMA_RE = re.compile(r"#\s*replint(?:-torch)?:\s*(?P<body>.*?)\s*$")
OK_RE = re.compile(r"^ok\s*\(\s*(?P<rules>[^)]*)\s*\)$")

#: pseudo-rules that are always active and not user-selectable
META_RULES = ("parse", "pragma")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One linter finding, stable across output formats."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def to_json(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class Pragma:
    """One parsed ``# replint:`` comment."""

    line: int           # line the comment sits on
    target: int         # code line the pragma governs
    kind: str           # "ok" | "hotpath" | "bad"
    rules: Tuple[str, ...] = ()
    text: str = ""


class Pragmas:
    """All ``# replint:`` pragmas of one file, indexed by target line."""

    def __init__(self, items: Sequence[Pragma]) -> None:
        self.items = list(items)
        self.ok_by_line: Dict[int, Set[str]] = {}
        self.hotpath_lines: Set[int] = set()
        for p in self.items:
            if p.kind == "ok":
                self.ok_by_line.setdefault(p.target, set()).update(p.rules)
            elif p.kind == "hotpath":
                self.hotpath_lines.add(p.target)

    def suppresses(self, finding: Finding) -> Optional[str]:
        """The rule name that suppresses ``finding``, or None."""
        rules = self.ok_by_line.get(finding.line, ())
        return finding.rule if finding.rule in rules else None


def _parse_pragmas(source: str) -> Pragmas:
    """Tokenize-based pragma scan (robust to ``#`` inside strings)."""
    pragmas: List[Pragma] = []
    comments: List[Tuple[int, int, str]] = []   # (line, col, text)
    code_lines: Set[int] = set()
    try:
        toks = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return Pragmas([])
    skip = {tokenize.COMMENT, tokenize.NL, tokenize.NEWLINE,
            tokenize.INDENT, tokenize.DEDENT, tokenize.ENDMARKER}
    for tok in toks:
        if tok.type == tokenize.COMMENT:
            comments.append((tok.start[0], tok.start[1], tok.string))
        elif tok.type not in skip:
            code_lines.add(tok.start[0])
            if tok.end[0] != tok.start[0]:
                code_lines.update(range(tok.start[0], tok.end[0] + 1))
    sorted_code = sorted(code_lines)

    def next_code_line(after: int) -> int:
        for ln in sorted_code:
            if ln > after:
                return ln
        return after  # trailing comment at EOF: govern itself

    for line, _col, text in comments:
        m = PRAGMA_RE.search(text)
        if not m:
            continue
        body = m.group("body")
        target = line if line in code_lines else next_code_line(line)
        if body == "hotpath":
            pragmas.append(Pragma(line, target, "hotpath"))
            continue
        ok = OK_RE.match(body)
        if ok:
            rules = tuple(r.strip() for r in ok.group("rules").split(",")
                          if r.strip())
            if rules:
                pragmas.append(Pragma(line, target, "ok", rules))
            else:
                pragmas.append(Pragma(line, target, "bad", (),
                                      "ok() pragma names no rule"))
            continue
        pragmas.append(Pragma(line, target, "bad", (),
                              f"unrecognized pragma {body!r} (expected "
                              f"'ok(<rule>)' or 'hotpath')"))
    return Pragmas(pragmas)


class FileContext:
    """Everything a rule needs to know about one source file."""

    def __init__(self, path: str, source: str, tree: ast.Module,
                 pragmas: Pragmas,
                 design_sections: Optional[Set[str]] = None) -> None:
        self.path = path
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self.pragmas = pragmas
        self.design_sections = design_sections
        norm = os.path.normpath(path).replace(os.sep, "/")
        self.parts: Tuple[str, ...] = tuple(norm.split("/"))
        self.filename = self.parts[-1] if self.parts else path

    def in_package_dirs(self, dirs: Sequence[str]) -> bool:
        """True when the file lives under ``repro_torch/<d>/`` for some d
        in ``dirs`` (matches both the real tree and test fixtures)."""
        for i, part in enumerate(self.parts[:-1]):
            if part == "repro_torch" and i + 1 < len(self.parts) \
                    and self.parts[i + 1] in dirs:
                return True
        return False


RuleFunc = Callable[[FileContext], Iterable[Finding]]

#: rule name -> (function, one-line description); insertion-ordered
RULES: Dict[str, Tuple[RuleFunc, str]] = {}


def register(name: str, description: str) -> Callable[[RuleFunc], RuleFunc]:
    def deco(fn: RuleFunc) -> RuleFunc:
        RULES[name] = (fn, description)
        return fn
    return deco


def _ensure_rules() -> None:
    if not RULES:
        from repro_torch.devtools.replint import rules as _rules  # noqa: F401


def rule_names() -> List[str]:
    _ensure_rules()
    return list(RULES)


# -- DESIGN.md section discovery ---------------------------------------------

_SECTION_RE = re.compile(r"§([A-Za-z0-9_]+(?:\.[0-9]+)*)")
_design_cache: Dict[str, Optional[Set[str]]] = {}


def _design_sections_for(path: str,
                         explicit: Optional[str] = None) -> Optional[Set[str]]:
    """Section tokens of the DESIGN.md governing ``path`` (nearest one
    walking up from the file), or None when there is none."""
    if explicit is not None:
        if explicit not in _design_cache:
            _design_cache[explicit] = _read_sections(explicit)
        return _design_cache[explicit]
    d = os.path.dirname(os.path.abspath(path))
    seen: List[str] = []
    while True:
        if d in _design_cache:
            sections = _design_cache[d]
            break
        seen.append(d)
        cand = os.path.join(d, "DESIGN.md")
        if os.path.isfile(cand):
            sections = _read_sections(cand)
            break
        parent = os.path.dirname(d)
        if parent == d:
            sections = None
            break
        d = parent
    for s in seen:
        _design_cache[s] = sections
    return sections


def _read_sections(design_path: str) -> Optional[Set[str]]:
    try:
        with open(design_path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return None
    sections: Set[str] = set()
    for line in text.splitlines():
        if line.lstrip().startswith("#"):
            sections.update(_SECTION_RE.findall(line))
    return sections


# -- driving -----------------------------------------------------------------

def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    """Expand files/dirs into a sorted, deduped list of ``.py`` files."""
    out: Set[str] = set()
    for p in paths:
        if os.path.isdir(p):
            for root, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if not d.startswith(".")
                                     and d != "__pycache__")
                for fn in filenames:
                    if fn.endswith(".py"):
                        out.add(os.path.join(root, fn))
        else:
            out.add(p)
    return iter(sorted(out))


def lint_file(path: str, select: Optional[Sequence[str]] = None,
              design: Optional[str] = None) -> List[Finding]:
    """Lint one file; returns surviving findings (pragma-suppressed ones
    removed, pragma-hygiene findings added)."""
    _ensure_rules()
    selected = list(select) if select is not None else list(RULES)
    full_run = set(selected) == set(RULES)
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    except OSError as e:
        return [Finding("parse", path, 1, 0, f"cannot read file: {e}")]
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("parse", path, e.lineno or 1, e.offset or 0,
                        f"syntax error: {e.msg}")]
    pragmas = _parse_pragmas(source)
    ctx = FileContext(path, source, tree, pragmas,
                      design_sections=_design_sections_for(path, design))

    raw: List[Finding] = []
    for name in selected:
        fn, _desc = RULES[name]
        raw.extend(fn(ctx))

    used: Set[Tuple[int, str]] = set()
    kept: List[Finding] = []
    for f in raw:
        rule = pragmas.suppresses(f)
        if rule is not None:
            used.add((f.line, rule))
        else:
            kept.append(f)

    # pragma hygiene: malformed, unknown-rule, and unused pragmas
    known = set(RULES) | set(META_RULES)
    for p in pragmas.items:
        if p.kind == "bad":
            kept.append(Finding("pragma", path, p.line, 0, p.text))
            continue
        if p.kind != "ok":
            continue
        for r in p.rules:
            if r not in known:
                kept.append(Finding(
                    "pragma", path, p.line, 0,
                    f"pragma names unknown rule {r!r} "
                    f"(known: {', '.join(sorted(known))})"))
            elif full_run and r in RULES and (p.target, r) not in used:
                kept.append(Finding(
                    "pragma", path, p.line, 0,
                    f"unused pragma: ok({r}) suppresses nothing on "
                    f"line {p.target}"))
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept


def lint_paths(paths: Sequence[str], select: Optional[Sequence[str]] = None,
               design: Optional[str] = None) -> Tuple[List[Finding], int]:
    """Lint files/directories; returns (findings, files_scanned)."""
    _ensure_rules()
    findings: List[Finding] = []
    n = 0
    for path in iter_python_files(paths):
        n += 1
        findings.extend(lint_file(path, select=select, design=design))
    return findings, n
