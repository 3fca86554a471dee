"""Shared infrastructure of the port's static rules: findings, parsed
modules with their suppressions and markers, the checker base, the tree
they scan and the committed baseline.

The port's own copy of `foremast_tpu/analysis/core.py`. Everything here
parses source with ``ast`` and never imports the checked modules, so a
scan costs well under a minute and touches no device.
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import hashlib
import json
import os
import re
from typing import Iterable, Sequence

PACKAGE = "foremast_tpu_torch"

# Per-line opt-out: `# foremast: ignore[rule-a,rule-b]` or the bare
# `# foremast: ignore` (all rules), on the finding's line or on a
# comment-only line directly above it, so the excuse moves with the code
# it excuses. Whitespace is tolerated anywhere in the form.
_SUPPRESS_RE = re.compile(r"#\s*foremast:\s*ignore(?:\s*\[(?P<rules>[a-z0-9_,\- ]+)\])?")
_ALL_RULES = "*"

# Positive annotations (`# foremast: device-boundary`): contract
# declarations that change what a rule checks, with the placement rules
# of suppressions.
_MARKER_RE = re.compile(r"#\s*foremast:\s*(?P<marker>[a-z][a-z-]+)")

# A file that does not parse is reported under this rule, not raised.
PARSE_RULE = "parse-error"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a file:line, with a fix hint.

    The fingerprint leaves the line out: a baselined finding survives
    edits above it, and two findings with one message in one file are
    the same debt wherever it drifts to.
    """

    rule: str
    path: str  # repo-relative, '/'-separated
    line: int
    message: str
    hint: str = ""

    def fingerprint(self) -> str:
        key = f"{self.rule}|{self.path}|{self.message}"
        return hashlib.sha256(key.encode()).hexdigest()[:16]

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "hint": self.hint,
            "fingerprint": self.fingerprint(),
        }

    def render(self) -> str:
        text = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            text += f"\n    hint: {self.hint}"
        return text

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.rule, self.message)


class Module:
    """One parsed source file plus its suppression map.

    A source that does not parse keeps an empty tree and its
    `parse_error` (line, message), which `analyze_modules` reports."""

    def __init__(self, relpath: str, source: str, abspath: str | None = None):
        self.relpath = relpath.replace(os.sep, "/")
        self.abspath = abspath or relpath
        self.source = source
        self.parse_error: tuple[int, str] | None = None
        try:
            self.tree = ast.parse(source, filename=self.relpath)
        except SyntaxError as e:
            self.tree = ast.Module(body=[], type_ignores=[])
            self.parse_error = (e.lineno or 1, e.msg)
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

    def marked(self, line: int, marker: str) -> bool:
        """True when `line` or the comment line right above it carries
        the `# foremast: <marker>` annotation (the placement rules of
        suppressions)."""
        for candidate in (line, line - 1):
            if candidate < 1 or candidate > len(self.lines):
                continue
            text = self.lines[candidate - 1]
            if candidate == line - 1 and not text.strip().startswith("#"):
                continue
            if any(m.group("marker") == marker for m in _MARKER_RE.finditer(text)):
                return True
        return False

    def marked_def(self, fn_node: ast.AST, marker: str) -> bool:
        """True when a function definition carries the marker: on the
        `def` line, the line above it, or above its first decorator."""
        lines = [fn_node.lineno]
        decos = getattr(fn_node, "decorator_list", [])
        if decos:
            lines.append(min(d.lineno for d in decos))
        return any(self.marked(ln, marker) for ln in lines)

    def finding(self, rule: str, node: ast.AST | int, message: str, hint: str = "") -> Finding:
        line = node if isinstance(node, int) else getattr(node, "lineno", 1)
        return Finding(rule=rule, path=self.relpath, line=line, message=message, hint=hint)


# The port's own files outside its package that the repo-scoped rules
# cover: its tests and helpers and the smoke script (the JAX package's
# tests/ and benchmarks/ are its own rules' business).
REPO_SCOPE = ("tests/test_torch_*.py", "tests/torch_*.py", "chip_smoke.py")


def in_package(relpath: str) -> bool:
    return relpath.startswith(f"{PACKAGE}/")


class Checker:
    """Base class: one rule ID, one `check(module)` pass."""

    rule: str = ""
    description: str = ""
    # "package": the port's package only; "repo": also the files of
    # REPO_SCOPE (fixture paths outside both still count).
    scope: str = "package"

    def applies_to(self, relpath: str) -> bool:
        if self.scope == "package" and (relpath.startswith("tests/") or relpath == "chip_smoke.py"):
            return False
        return True

    def check(self, module: Module) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError


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


def default_paths(root: str) -> list[str]:
    """What the runner's full scan reads: the package and the files of
    REPO_SCOPE. Package-scoped rules skip the latter (`Checker.applies_to`)."""
    out = [os.path.join(root, PACKAGE)]
    for pattern in REPO_SCOPE:
        out += sorted(glob.glob(os.path.join(root, pattern)))
    return out


def collect_modules(root: str, paths: Sequence[str] | None = None) -> list[Module]:
    """Parse every .py file under `paths` (default: the port's
    package), sorted by path. A file that does not parse is kept with
    its `parse_error`."""
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


def _module_findings(module: Module, checkers: Sequence[Checker]) -> list[Finding]:
    if module.parse_error is not None:
        line, msg = module.parse_error
        return [module.finding(PARSE_RULE, line, f"file does not parse: {msg}",
                               hint="no rule can check a file that does not parse")]
    out = []
    for checker in checkers:
        if checker.applies_to(module.relpath):
            out += [f for f in checker.check(module) if not module.suppressed(f.line, f.rule)]
    return out


def analyze_source(source: str, relpath: str, checkers: Iterable[Checker]) -> list[Finding]:
    """Run checkers over one source string: the fixture tests' entry
    point, and the shape `analyze_modules` loops over."""
    return sorted(set(_module_findings(Module(relpath, source), list(checkers))), key=Finding.sort_key)


def analyze_modules(modules: Iterable[Module], checkers: Iterable[Checker]) -> list[Finding]:
    checkers = list(checkers)
    findings = [f for module in modules for f in _module_findings(module, checkers)]
    return sorted(set(findings), key=Finding.sort_key)


class Baseline:
    """The committed grandfather list (`analysis_baseline_torch.json`).

    Matching is by fingerprint (rule, path and message, not the line):
    a baselined finding may move within its file, but any new message,
    the same fault in another file included, fails the gate. `stale()`
    reports entries whose debt is paid, so the file only shrinks."""

    VERSION = 1

    def __init__(self, entries: Sequence[dict] | None = None):
        self.entries = list(entries or [])
        self._by_fp = {e["fingerprint"]: e for e in self.entries}

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f).get("findings", []))

    @classmethod
    def from_findings(cls, findings: Sequence[Finding]) -> "Baseline":
        return cls([
            {"rule": f.rule, "path": f.path, "message": f.message, "fingerprint": f.fingerprint()}
            for f in sorted(set(findings), key=Finding.sort_key)
        ])

    def save(self, path: str) -> None:
        payload = {
            "version": self.VERSION,
            "comment": "Grandfathered findings of the port's static rules. New findings fail "
            "`python -m foremast_tpu_torch.analysis`; shrink this file, never grow it.",
            "findings": self.entries,
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")

    def split(self, findings: Sequence[Finding]) -> tuple[list[Finding], list[Finding]]:
        """(new, grandfathered) partition of `findings`."""
        new, old = [], []
        for f in findings:
            (old if f.fingerprint() in self._by_fp else new).append(f)
        return new, old

    def stale(self, findings: Sequence[Finding]) -> list[dict]:
        live = {f.fingerprint() for f in findings}
        return [e for e in self.entries if e["fingerprint"] not in live]
