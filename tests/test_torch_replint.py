"""The port's copy of the replint invariant linter
(``repro_torch.devtools.replint``, DESIGN.md §13): its rules that guard
the simulator fire on files under ``repro_torch/<net|runtime>/``, the
port's sources sweep clean, and each ``# replint-torch:`` pragma the
port carries (the SSP clock scan, the analytic transport's close
callback, the reliable-protocol bsp flows, the receiver's mask fill and
the ToR switch's grouping keys) is needed: stripped, its site is
flagged.

Both linters sweep ``src/``. The JAX copy's determinism and gen-fence
rules are scoped to ``repro/``, so it would report a plain
``# replint: ok(determinism)`` in a port file as an unused pragma; the
port writes those pragmas as ``# replint-torch: ok(...)``, which only
its own copy reads."""
import os
import re
import textwrap

import pytest

from repro.devtools.replint import lint_file as jlint_file
from repro.devtools.replint import lint_paths as jlint_paths
from repro_torch.devtools.replint import lint_file, lint_paths, rule_names
from repro_torch.devtools.replint.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SRC = os.path.join(REPO, "src", "repro_torch")
PORT_PRAGMA = re.compile(r"\s*# replint-torch: ok\((?P<rule>[a-z-]+)\)")


def _write(tmp_path, rel, source):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return str(p)


def _lint(tmp_path, rel, source, select=None):
    return lint_file(_write(tmp_path, rel, source), select=select)


def _rules(findings):
    return [f.rule for f in findings]


# --------------------------------------------------------------------------
# the three simulator rules: a fires/silent pair each, at a port path

FIXTURES = {
    "determinism": ("repro_torch/net/mod.py", """\
        def f(xs):
            s = set(xs)
            for x in s:
                print(x)
        """, """\
        def f(xs):
            s = set(xs)
            for x in sorted(s):
                print(x)
        """),
    "gen-fence": ("repro_torch/runtime/mod.py", """\
        class R:
            def arm(self, t):
                def cb():
                    self.count += 1
                    self.apply()
                self.sim.at(t, cb)
        """, """\
        class R:
            def arm(self, t):
                def cb():
                    if self.closed:
                        return
                    self.count += 1
                    self.apply()
                self.sim.at(t, cb)
        """),
    "pool-reset": ("repro_torch/net/flows.py", """\
        class Flow:
            def __init__(self, sim):
                self.sim = sim
                self.buf = []

            def reset(self, gen):
                self.gen = gen
        """, """\
        class Flow:
            def __init__(self, sim):
                self.sim = sim
                self.buf = []

            def reset(self, gen):
                self.gen = gen
                self.buf = []
        """),
}


@pytest.mark.parametrize("rule", list(FIXTURES))
def test_rule_fires_on_the_port(tmp_path, rule):
    rel, bad, _ = FIXTURES[rule]
    fs = _lint(tmp_path, rel, bad, select=[rule])
    assert _rules(fs) == [rule], fs


@pytest.mark.parametrize("rule", list(FIXTURES))
def test_rule_silent_on_the_fix(tmp_path, rule):
    rel, _, good = FIXTURES[rule]
    assert _lint(tmp_path, rel, good, select=[rule]) == []


@pytest.mark.parametrize("rule", ["determinism", "gen-fence"])
def test_scoped_rules_are_the_ports_own(tmp_path, rule):
    """The port's copy is silent under ``repro/``, where the JAX copy
    fires, and the JAX copy is silent under ``repro_torch/``."""
    rel, bad, _ = FIXTURES[rule]
    jax_rel = rel.replace("repro_torch/", "repro/")
    assert _lint(tmp_path, jax_rel, bad, select=[rule]) == []
    assert _rules(jlint_file(_write(tmp_path, jax_rel, bad),
                             select=[rule])) == [rule]
    assert jlint_file(_write(tmp_path, rel, bad), select=[rule]) == []


# --------------------------------------------------------------------------
# the port's pragma form


def test_port_pragma_suppresses_and_the_jax_copy_ignores_it(tmp_path):
    src = """\
        def f(xs):
            s = set(xs)
            return [x for x in s]  # replint-torch: ok(determinism)
        """
    path = _write(tmp_path, "repro_torch/net/mod.py", src)
    assert lint_file(path) == []
    assert jlint_file(path) == []
    # without its pragma the port's copy flags the line
    bare = _write(tmp_path, "repro_torch/net/bare.py",
                  src.replace("  # replint-torch: ok(determinism)", ""))
    assert _rules(lint_file(bare)) == ["determinism"]


def test_plain_pragma_in_a_port_file_is_unused_for_the_jax_copy(tmp_path):
    """Why the port has its own form: the plain one suppresses the
    port's finding but is an unused pragma to the JAX copy."""
    path = _write(tmp_path, "repro_torch/net/mod.py", """\
        def f(xs):
            s = set(xs)
            return [x for x in s]  # replint: ok(determinism)
        """)
    assert lint_file(path) == []
    assert _rules(jlint_file(path)) == ["pragma"]


def test_unused_port_pragma_is_reported(tmp_path):
    fs = _lint(tmp_path, "repro_torch/net/mod.py", """\
        x = 1  # replint-torch: ok(determinism)
        """)
    assert _rules(fs) == ["pragma"] and "unused" in fs[0].message


# --------------------------------------------------------------------------
# every port pragma is needed


def _port_pragma_sites():
    sites = []
    for root, dirs, files in os.walk(PORT_SRC):
        # the linter's own docstrings show the pragma grammar
        dirs[:] = sorted(d for d in dirs
                         if d not in ("__pycache__", "devtools"))
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path, encoding="utf-8") as f:
                for i, line in enumerate(f, 1):
                    m = PORT_PRAGMA.search(line)
                    if m:
                        sites.append((os.path.relpath(path, PORT_SRC), i,
                                      m.group("rule")))
    return sites


SITES = _port_pragma_sites()


def test_the_restored_pragmas_are_in_place():
    """The SSP clock scan and the analytic transport's close callback
    carry their pragmas, as the JAX files do; so does the reliable bsp
    flow callback of the DES runtime."""
    got = {(path, rule) for path, _, rule in SITES}
    assert ("runtime/policies.py", "determinism") in got
    assert ("runtime/transport.py", "gen-fence") in got
    assert ("runtime/runtime.py", "gen-fence") in got


@pytest.mark.parametrize("path,line,rule", SITES,
                         ids=[f"{p}:{n}" for p, n, _ in SITES])
def test_stripped_pragma_is_flagged(tmp_path, path, line, rule):
    with open(os.path.join(PORT_SRC, path), encoding="utf-8") as f:
        lines = f.read().splitlines(keepends=True)
    lines[line - 1] = PORT_PRAGMA.sub("", lines[line - 1])
    copy = tmp_path / "repro_torch" / path
    copy.parent.mkdir(parents=True)
    copy.write_text("".join(lines))
    fs = lint_file(str(copy), select=[rule])
    assert any(f.rule == rule and f.line == line for f in fs), fs


# --------------------------------------------------------------------------
# the port's sources, the registry and the CLI


def test_port_sweep_is_clean():
    findings, n_files = lint_paths([PORT_SRC])
    assert findings == [], "\n".join(f.render() for f in findings)
    assert n_files > 50


def test_jax_copy_sweeps_the_port_clean():
    findings, _ = jlint_paths([PORT_SRC])
    assert findings == [], "\n".join(f.render() for f in findings)


def test_rule_registry_is_complete():
    assert rule_names() == ["determinism", "pool-reset", "gen-fence",
                            "hotpath", "frozen-config", "design-ref"]


def test_cli_exit_codes(tmp_path, capsys):
    rel, bad, good = FIXTURES["determinism"]
    assert main([_write(tmp_path, rel, bad)]) == 1
    assert main([_write(tmp_path, "repro_torch/net/ok.py", good)]) == 0
    assert main([]) == 2
    assert main(["--select", "nope", str(tmp_path)]) == 2
    assert "[determinism]" in capsys.readouterr().out
