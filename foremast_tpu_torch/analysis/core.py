"""Shared infrastructure of the port's static rules: findings, parsed
modules with their suppressions, and the tree they scan.

The port's own copy of what `foremast_tpu/analysis/core.py` gives the
lock graph and the env contract. Everything here parses source with
``ast`` and never imports the checked modules, so a scan costs
milliseconds and touches no device.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Sequence

PACKAGE = "foremast_tpu_torch"

# Per-line opt-out: `# foremast: ignore[rule-a,rule-b]` or the bare
# `# foremast: ignore` (all rules), on the finding's line or on a
# comment-only line directly above it, so the excuse moves with the code
# it excuses. Whitespace is tolerated anywhere in the form.
_SUPPRESS_RE = re.compile(r"#\s*foremast:\s*ignore(?:\s*\[(?P<rules>[a-z0-9_,\- ]+)\])?")
_ALL_RULES = "*"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a file:line, with a fix hint."""

    rule: str
    path: str  # repo-relative, '/'-separated
    line: int
    message: str
    hint: str = ""

    def render(self) -> str:
        text = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            text += f"\n    hint: {self.hint}"
        return text

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.rule, self.message)


class Module:
    """One parsed source file plus its suppression map."""

    def __init__(self, relpath: str, source: str, abspath: str | None = None):
        self.relpath = relpath.replace(os.sep, "/")
        self.abspath = abspath or relpath
        self.source = source
        self.tree = ast.parse(source, filename=self.relpath)
        self.lines = source.splitlines()
        self._suppressions = self._parse_suppressions(self.lines)

    @staticmethod
    def _parse_suppressions(lines: Sequence[str]) -> dict[int, frozenset[str]]:
        out: dict[int, frozenset[str]] = {}
        for i, line in enumerate(lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = m.group("rules")
            if rules:
                out[i] = frozenset(r.strip() for r in rules.split(",") if r.strip())
            else:
                out[i] = frozenset({_ALL_RULES})
        return out

    def suppressed(self, line: int, rule: str) -> bool:
        """True when `line` (or a comment-only line right above it)
        carries an ignore for `rule`."""
        for candidate in (line, line - 1):
            if candidate < 1:
                continue
            rules = self._suppressions.get(candidate)
            if rules is None:
                continue
            # the line above counts only when it is a pure comment: a
            # suppression on another statement must not leak downward
            if candidate == line - 1 and not self.lines[candidate - 1].strip().startswith("#"):
                continue
            if _ALL_RULES in rules or rule in rules:
                return True
        return False

    def finding(self, rule: str, node: ast.AST | int, message: str, hint: str = "") -> Finding:
        line = node if isinstance(node, int) else getattr(node, "lineno", 1)
        return Finding(rule=rule, path=self.relpath, line=line, message=message, hint=hint)


def os_import_aliases(tree: ast.Module, member: str) -> frozenset[str]:
    """Bare names that alias `os.<member>` in this module (`from os
    import environ [as e]`). A WSGI handler's `environ` dict parameter is
    not the process environment: only a real import makes a bare name
    mean it."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "os":
            for alias in node.names:
                if alias.name == member:
                    out.add(alias.asname or alias.name)
    return frozenset(out)


def repo_root() -> str:
    """The checkout the default scan reads: the directory holding the
    `foremast_tpu_torch` package and `analysis_lockgraph_torch.json`."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def collect_modules(root: str, paths: Sequence[str] | None = None) -> list[Module]:
    """Parse every .py file under `paths` (default: the port's
    package), sorted by path."""
    targets = list(paths) if paths else [os.path.join(root, PACKAGE)]
    files: list[str] = []
    for target in targets:
        if os.path.isfile(target):
            files.append(target)
            continue
        for dirpath, dirnames, filenames in os.walk(target):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            files.extend(os.path.join(dirpath, f) for f in filenames if f.endswith(".py"))
    modules = []
    for path in sorted(set(files)):
        with open(path, encoding="utf-8") as f:
            modules.append(Module(os.path.relpath(path, root), f.read(), abspath=path))
    return modules
