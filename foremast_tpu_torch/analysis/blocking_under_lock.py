"""blocking-under-lock: I/O and sleeps while holding a lock.

The port's copy of `foremast_tpu/analysis/blocking_under_lock.py`. Every
lock of the port's data plane sits on a path some other thread needs:
the receiver's handler threads contend on the shard locks the tick
thread fetches through, the scrape handler reads counters behind the
locks the snapshot pass holds, and the fit journal's lock serializes
the judge's write-through. A blocking call inside any of those critical
sections turns one slow disk or one dead socket into a fleet-wide stall.

Flagged while any known lock is held (directly in the `with` body, or
transitively through calls `interproc.Program` can follow):

  * ``time.sleep``;
  * HTTP and network dials (``requests.*``, ``urllib.request.*``,
    ``http.client.*``, on which the port's `httpclient.Session` is
    built, ``socket.create_connection``) and session verbs on session-shaped
    receivers (``self._s.post`` / ``*_session.get``);
  * ``subprocess.*`` / ``os.system`` / ``os.popen``;
  * ``open()``, ``os.fsync``, ``os.replace`` and file-handle
    ``.write``/``.flush`` on handle-shaped receivers (``fh``/``f``/
    ``self._fh``);
  * the synchronous JobStore surface (``store.claim(...)`` and the rest:
    an Elasticsearch round trip under a lock).

The deliberate cases stay, suppressed in place with the reason: the
suppression is the documentation. The ring journal hook is the main
one: it runs under the owning shard's lock on purpose, because the
replayed log order must equal the apply order (see `RingShard.push`).
"""

from __future__ import annotations

import ast

from foremast_tpu_torch.analysis.core import Finding, Module
from foremast_tpu_torch.analysis.interproc import FunctionInfo, Program, dotted, locked_walk

RULE = "blocking-under-lock"

_BLOCKING_EXACT = {
    "time.sleep": "a sleep",
    "os.system": "a subprocess",
    "os.popen": "a subprocess",
    "os.fsync": "an fsync",
    "os.replace": "a rename",
    "socket.create_connection": "a socket dial",
}
_BLOCKING_PREFIXES = {
    "requests.": "an HTTP call",
    "subprocess.": "a subprocess",
    "urllib.request.": "an HTTP call",
    "http.client.": "an HTTP call",
}
_STORE_METHODS = frozenset(
    {
        "create", "get", "claim", "update", "update_many", "list_open",
        "list_app", "count_open", "wait_ready", "ensure_index",
    }
)
_SESSION_VERBS = frozenset({"get", "post", "put", "delete", "head", "request"})
_HANDLE_NAMES = frozenset({"fh", "f", "file", "_fh"})
_HANDLE_VERBS = frozenset({"write", "flush"})


def _receiver_name(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def classify_blocking(call: ast.Call) -> str | None:
    """A short description of the blocking operation this call
    performs, or None. Shared with the interprocedural summaries."""
    func = call.func
    d = dotted(func)
    if d is not None:
        desc = _BLOCKING_EXACT.get(d)
        if desc is not None:
            return f"{desc} (`{d}`)"
        for prefix, desc in _BLOCKING_PREFIXES.items():
            if d.startswith(prefix):
                return f"{desc} (`{d}`)"
    if isinstance(func, ast.Name) and func.id == "open":
        return "a file open (`open`)"
    if isinstance(func, ast.Attribute):
        recv = _receiver_name(func.value)
        if recv is not None:
            if func.attr in _STORE_METHODS and (recv == "store" or recv.endswith("_store")):
                return f"a store round trip (`{recv}.{func.attr}`)"
            if func.attr in _SESSION_VERBS and (
                recv in ("_s", "_probe_s", "session") or recv.endswith("_session")
            ):
                return f"an HTTP call (`{recv}.{func.attr}`)"
            if func.attr in _HANDLE_VERBS and recv in _HANDLE_NAMES:
                return f"file I/O (`{recv}.{func.attr}`)"
    return None


def check_blocking_under_lock(program: Program) -> list[Finding]:
    """Whole-program pass: every function is walked with its own
    held-lock stack; a blocking call, or a call whose transitive summary
    blocks, inside a locked region is a finding."""
    findings: list[Finding] = []
    for fn in program.functions:
        for node, held, acquired in locked_walk(program, fn):
            if acquired is None and held and isinstance(node, ast.Call):
                findings.extend(_check_call(program, fn, node, held))
    return findings


def _check_call(program: Program, fn: FunctionInfo, call: ast.Call, held: list) -> list[Finding]:
    lock_names = "/".join(str(lk) for lk in held)
    desc = classify_blocking(call)
    if desc is not None:
        return [_finding(fn, call, f"{desc} while holding {lock_names} in `{fn.qualname}` "
                         "stalls every thread contending on that lock")]
    for callee in program.resolve_call(call, fn):
        if callee.blocks_all:
            rep_desc, rep_site = sorted(callee.blocks_all.items())[0]
            # one finding per call site, not one per target
            return [_finding(fn, call, f"call `{callee.qualname}(...)` reaches {rep_desc} at "
                             f"{rep_site} while holding {lock_names} in `{fn.qualname}`")]
    return []


def _finding(fn: FunctionInfo, node: ast.AST, message: str) -> Finding:
    return Finding(
        rule=RULE,
        path=fn.module.relpath,
        line=getattr(node, "lineno", fn.node.lineno),
        message=message,
        hint="move the I/O outside the critical section (copy under the lock, write outside), "
        "or mark a deliberate hold with `# foremast: ignore[blocking-under-lock]` and the "
        "contract that makes it sound",
    )


def apply_suppressions(findings: list[Finding], modules: list[Module]) -> list[Finding]:
    """Per-line `# foremast: ignore[...]` filtering for the whole-program
    rules (the per-module path applies it inside `analyze_modules`)."""
    by_path = {m.relpath: m for m in modules}
    out = []
    for f in findings:
        m = by_path.get(f.path)
        if m is not None and m.suppressed(f.line, f.rule):
            continue
        out.append(f)
    return sorted(set(out), key=Finding.sort_key)
