"""Developer tooling that ships with the port and never imports from (or
into) the simulation fast path.

``repro_torch.devtools.replint`` is the port's copy of the AST-based
invariant linter (DESIGN.md §13); it is pure stdlib and safe to run
anywhere.
"""
