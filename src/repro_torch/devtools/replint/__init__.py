"""replint — AST-based invariant linter, the port's copy (DESIGN.md §13).

A copy of the JAX package's ``devtools/replint``, scoped to the port:
the rules that guard the simulator (determinism, gen-fence) fire on
files under ``repro_torch/<net|runtime>/``, where the JAX copy's fire
under ``repro/<net|runtime>/``. It imports nothing of the JAX package.

The simulator's correctness rests on hand-enforced invariants: bitwise
same-seed replay, generation-fenced pooled flows, tracker-off hot-path
parity, hashable frozen configs. ``replint`` mechanizes them as six
static checks over ``src/repro_torch/``:

  determinism     no wall clocks, global RNG, ``id()`` keys, or
                  set-iteration-order dependence in net/ and runtime/
  pool-reset      classes implementing the pooling ``reset()`` protocol
                  must reset every mutable attribute ``__init__`` makes
  gen-fence       ``meta["g"]`` only through ``repro_torch.net.genfence``;
                  sim-registered closures in runtime/ carry a staleness
                  guard
  hotpath         functions marked ``# replint: hotpath`` allocate no
                  closures / comprehensions / f-strings off-tracker
  frozen-config   frozen dataclasses in config.py stay hashable
  design-ref      §N citations into DESIGN.md resolve to real sections

Findings are suppressed per line with ``# replint: ok(<rule>)`` — the
rule name is mandatory, and unused or malformed pragmas are themselves
findings. CLI: ``python -m repro_torch.devtools.replint src/repro_torch/``.

Both linters sweep ``src/``, so each reads the other's files. A
``# replint: ok(determinism)`` or ``ok(gen-fence)`` pragma in the port
would suppress nothing under the JAX copy (those rules are scoped to
``repro/``) and be reported there as unused. So this copy also reads
``# replint-torch: <directive>``, which the JAX copy ignores: port files
write their determinism and gen-fence pragmas in that form, and keep
the plain form for the unscoped rules (pool-reset, hotpath), which both
linters run.

Stdlib only; importing this package never touches the sim modules.
"""
from repro_torch.devtools.replint.core import (
    Finding,
    RULES,
    iter_python_files,
    lint_file,
    lint_paths,
    rule_names,
)

__all__ = [
    "Finding",
    "RULES",
    "iter_python_files",
    "lint_file",
    "lint_paths",
    "rule_names",
]
