"""env-contract: every env read of the port names a registered knob.

The port's copy of the rules of `foremast_tpu/analysis/env_contract.py`.
`foremast_tpu_torch/config.py` declares the registry (``ENV_KNOBS``:
name, default, kind, description, group); every literal env read
anywhere else in the package must name a registered knob. A read of a
*computed* name is flagged too, since it defeats enumeration: a thin
wrapper whose call sites pass literals documents itself with a
``# foremast: ignore[env-contract]`` at its one dynamic read.

What counts as a read: ``os.environ.get(...)``, ``os.getenv(...)``,
``os.environ[...]``, and the same through a ``from os import environ``
or ``getenv`` alias. A bare ``environ`` that is not imported from `os`
(a WSGI handler's dict, with its ``PATH_INFO`` and ``REQUEST_METHOD``)
is not the process environment and does not count.

The registry is also the source of the knob table in the README's port
section (`env_table()`, between the ``ENV REGISTRY (TORCH)`` markers);
`check_env_docs` reports a table that has drifted from the registry.
"""

from __future__ import annotations

import ast
import os
from typing import Sequence

from foremast_tpu_torch.analysis.core import Finding, Module, collect_modules, os_import_aliases, repo_root

RULE = "env-contract"
# the registry module itself
EXEMPT = ("foremast_tpu_torch/config.py",)

DOCS_RELPATH = "README.md"
DOCS_BEGIN = "<!-- BEGIN ENV REGISTRY (TORCH) (generated: python -m foremast_tpu_torch.analysis --update-env-docs) -->"
DOCS_END = "<!-- END ENV REGISTRY (TORCH) -->"


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def registered_names() -> frozenset[str]:
    from foremast_tpu_torch.config import ENV_KNOB_NAMES

    return ENV_KNOB_NAMES


def check_module(module: Module, names: frozenset[str]) -> list[Finding]:
    """The env-contract findings of one parsed module (suppressions not
    yet applied)."""
    environ_names = {"os.environ"} | set(os_import_aliases(module.tree, "environ"))
    read_calls = (
        {"os.getenv", "os.environ.get"}
        | {f"{a}.get" for a in environ_names if a != "os.environ"}
        | set(os_import_aliases(module.tree, "getenv"))
    )
    findings: list[Finding] = []
    for node in ast.walk(module.tree):
        name_node = None
        if isinstance(node, ast.Call) and _dotted(node.func) in read_calls:
            if node.args:
                name_node = node.args[0]
        elif (
            isinstance(node, ast.Subscript)
            and isinstance(node.ctx, ast.Load)
            and _dotted(node.value) in environ_names
        ):
            name_node = node.slice
        if name_node is None:
            continue
        if isinstance(name_node, ast.Constant) and isinstance(name_node.value, str):
            if name_node.value not in names:
                findings.append(module.finding(
                    RULE, node,
                    f"env var {name_node.value!r} read here is not declared in config.ENV_KNOBS",
                    hint="add an EnvKnob entry (name, default, kind, description) in "
                    "foremast_tpu_torch/config.py",
                ))
        else:
            findings.append(module.finding(
                RULE, node, "env read with a computed name defeats knob enumeration",
                hint="read literals (register each), or suppress a thin wrapper whose call sites pass "
                "literals with `# foremast: ignore[env-contract]`",
            ))
    return findings


def env_findings(paths: Sequence[str] | None = None, names: frozenset[str] | None = None,
                 root: str | None = None) -> list[Finding]:
    """Unregistered and computed env reads in the .py files under `paths`
    (default: the port's package), suppressions applied, sorted."""
    root = root or repo_root()
    names = registered_names() if names is None else names
    findings: list[Finding] = []
    for module in collect_modules(root, paths):
        if module.relpath in EXEMPT:
            continue
        findings += [f for f in check_module(module, names) if not module.suppressed(f.line, f.rule)]
    return sorted(set(findings), key=Finding.sort_key)


# ---------------------------------------------------------------------------
# the generated knob table
# ---------------------------------------------------------------------------


def env_table() -> str:
    """The README's knob block, rendered from config.ENV_KNOBS: registry
    order within each group, groups in a fixed order."""
    from foremast_tpu_torch.config import ENV_KNOBS

    groups = [
        ("engine", "Engine (reference parity, `foremast-brain.yaml:21-81` + `foremast-brain/README.md:20-38`):"),
        ("framework", "Framework-specific:"),
        ("deploy", "Deployment / platform integration:"),
    ]
    lines = [DOCS_BEGIN, ""]
    for group, heading in groups:
        knobs = [k for k in ENV_KNOBS if k.group == group]
        if not knobs:
            continue
        lines += [heading, "", "| Var | Default | Meaning |", "|---|---|---|"]
        for k in knobs:
            default = k.default if k.default not in (None, "") else "—"
            desc = k.description.replace("|", "\\|")
            lines.append(f"| `{k.name}` | {default.replace('|', chr(92) + '|')} | {desc} |")
        lines.append("")
    lines.append(
        "This table is generated from `foremast_tpu_torch/config.py`'s `ENV_KNOBS` registry: edit the "
        "registry, then run `python -m foremast_tpu_torch.analysis --update-env-docs`."
    )
    lines.append(DOCS_END)
    return "\n".join(lines)


def _split_docs(text: str) -> tuple[str, str, str] | None:
    try:
        head, rest = text.split(DOCS_BEGIN, 1)
        _, tail = rest.split(DOCS_END, 1)
    except ValueError:
        return None
    return head, text[len(head): len(text) - len(tail)], tail


def check_env_docs(root: str | None = None) -> list[Finding]:
    """A finding when the README's block is missing or stale."""
    root = root or repo_root()
    with open(os.path.join(root, DOCS_RELPATH), encoding="utf-8") as f:
        text = f.read()
    parts = _split_docs(text)
    hint = "run `python -m foremast_tpu_torch.analysis --update-env-docs`"
    if parts is None:
        return [Finding(RULE, DOCS_RELPATH, 1, "ENV REGISTRY (TORCH) markers missing from the README", hint)]
    if parts[1] != env_table():
        line = text[: text.index(DOCS_BEGIN)].count("\n") + 1
        return [Finding(RULE, DOCS_RELPATH, line, "generated env table is stale vs config.ENV_KNOBS", hint)]
    return []


def update_env_docs(root: str | None = None) -> bool:
    """Rewrite the README's block in place; True if it changed."""
    root = root or repo_root()
    path = os.path.join(root, DOCS_RELPATH)
    with open(path, encoding="utf-8") as f:
        text = f.read()
    parts = _split_docs(text)
    if parts is None:
        raise SystemExit(f"{DOCS_RELPATH}: markers not found; add\n{DOCS_BEGIN}\n{DOCS_END}\nwhere the table belongs")
    head, old, tail = parts
    new = env_table()
    if old == new:
        return False
    with open(path, "w", encoding="utf-8") as f:
        f.write(head + new + tail)
    return True
