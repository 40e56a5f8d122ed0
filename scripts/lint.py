#!/usr/bin/env python
"""Stdlib-only lint/format gate — runnable anywhere (no pip deps), used by CI and the
pre-commit hook.  Role parity with the reference's format gate (.github/workflows/ci.yml
clang-format job + .githooks/pre-commit): the reference gates C formatting; this repo is
Python + C++, so the gate covers both.

Checks (exit 1 on any violation, one line per finding):
  python:  syntax (compile), tabs, trailing whitespace, line length, missing EOF newline,
           unused top-level imports (ast-based, with an explicit allow-list for re-exports)
  c++:     tabs, trailing whitespace, line length, missing EOF newline

CI additionally runs ruff (configured in pyproject.toml) for the deeper pyflakes-class
checks; this script is the subset every contributor can run with a bare interpreter.
"""

from __future__ import annotations

import ast
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
MAX_LEN = 99
MAX_LEN_CPP = 100

PY_DIRS = ["tpusparse", "tests", "scripts"]
PY_FILES = ["bench.py", "__graft_entry__.py", "chip_smoke.py"]
CPP_DIRS = ["csrc"]

# modules imported for side effects / re-export, exempt from the unused-import check
IMPORT_ALLOW = {"__init__.py": {"*"}, "conftest.py": {"*"}}


def _py_paths():
    for d in PY_DIRS:
        yield from sorted((ROOT / d).rglob("*.py"))
    for f in PY_FILES:
        p = ROOT / f
        if p.exists():
            yield p


def _cpp_paths():
    for d in CPP_DIRS:
        for ext in ("*.cpp", "*.h", "*.hpp"):
            yield from sorted((ROOT / d).rglob(ext))


def _check_text(path: pathlib.Path, text: str, max_len: int, errors: list):
    rel = path.relative_to(ROOT)
    if text and not text.endswith("\n"):
        errors.append(f"{rel}: missing newline at end of file")
    for i, line in enumerate(text.splitlines(), 1):
        if "\t" in line:
            errors.append(f"{rel}:{i}: tab character")
        if line != line.rstrip():
            errors.append(f"{rel}:{i}: trailing whitespace")
        if len(line) > max_len:
            errors.append(f"{rel}:{i}: line too long ({len(line)} > {max_len})")


def _unused_imports(path: pathlib.Path, tree: ast.AST, text: str, errors: list):
    rel = path.relative_to(ROOT)
    allowed = IMPORT_ALLOW.get(path.name, set())
    if "*" in allowed:
        return
    imported = {}  # name -> lineno, top-level imports only
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                imported[name] = node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue  # compiler directive, not a name binding to use
            for a in node.names:
                if a.name == "*":
                    continue
                imported[a.asname or a.name] = node.lineno
    if not imported:
        return
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            n = node
            while isinstance(n, ast.Attribute):
                n = n.value
            if isinstance(n, ast.Name):
                used.add(n.id)
    # names referenced only in docstrings/comments (e.g. documented aliases) count as unused
    for name, lineno in sorted(imported.items()):
        if name not in used and name not in allowed:
            errors.append(f"{rel}:{lineno}: unused import '{name}'")


def main() -> int:
    errors: list = []
    for path in _py_paths():
        text = path.read_text(encoding="utf-8")
        _check_text(path, text, MAX_LEN, errors)
        try:
            tree = ast.parse(text, filename=str(path))
        except SyntaxError as e:
            errors.append(f"{path.relative_to(ROOT)}:{e.lineno}: syntax error: {e.msg}")
            continue
        _unused_imports(path, tree, text, errors)
    for path in _cpp_paths():
        _check_text(path, path.read_text(encoding="utf-8"), MAX_LEN_CPP, errors)
    if errors:
        print("\n".join(errors))
        print(f"\nlint: {len(errors)} finding(s)")
        return 1
    print("lint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
