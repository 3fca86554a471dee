"""async-blocking: synchronous I/O and sleeps inside ``async def`` bodies.

The port's copy of `foremast_tpu/analysis/async_blocking.py`. The port's
gateway, dashboard and receivers serve on `ThreadingHTTPServer`, so its
event loops are the ones it lends: `instrument/starter.py`'s
`instrument_aiohttp` middleware runs on the instrumented app's aiohttp
loop, and the port's async tests drive their own. One blocking call in
such a body stalls every request on that loop, the liveness probes
included. The convention is to push blocking work through
``asyncio.to_thread``, which passes the function *uncalled*, so this
checker's call-site detection permits it.

Flagged inside ``async def`` bodies (nested sync defs excluded: they may
run on executor threads):

  * ``time.sleep`` (use ``asyncio.sleep``);
  * ``requests.*`` / ``urllib.request.*`` / raw ``socket`` dials;
  * ``subprocess.*`` and ``os.system``/``os.popen`` (use
    ``asyncio.create_subprocess_exec``);
  * direct calls of the synchronous JobStore / Elasticsearch surface:
    ``store.create(...)``, ``store.claim(...)`` and the rest on a
    receiver named ``store``/``*_store`` (wrap in ``asyncio.to_thread``);
  * bare ``open()`` (read at startup, or ``asyncio.to_thread``).

The rule is repo-scoped: it also reads the port's tests and
`chip_smoke.py`.
"""

from __future__ import annotations

import ast

from foremast_tpu_torch.analysis.core import Checker, Finding, Module

# exact dotted names
_BLOCKING_EXACT = {
    "time.sleep": "use `await asyncio.sleep(...)`",
    "os.system": "use `asyncio.create_subprocess_shell`",
    "os.popen": "use `asyncio.create_subprocess_shell`",
    "socket.create_connection": "use loop-native I/O (aiohttp / asyncio streams)",
}
# dotted-prefix families
_BLOCKING_PREFIXES = {
    "requests.": "use the app's aiohttp ClientSession",
    "subprocess.": "use `asyncio.create_subprocess_exec`",
    "urllib.request.": "use the app's aiohttp ClientSession",
}
# the synchronous JobStore/ES surface (jobs/store.py): calling any of
# these directly on the loop blocks on HTTP to Elasticsearch
_STORE_METHODS = frozenset(
    {
        "create",
        "get",
        "claim",
        "update",
        "update_many",
        "list_open",
        "count_open",
        "wait_ready",
        "ensure_index",
    }
)


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _store_receiver(node: ast.AST) -> str | None:
    """Name of a store-like receiver (`store`, `job_store`,
    `self.store`), or None."""
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    else:
        return None
    if name == "store" or name.endswith("_store"):
        return name
    return None


class AsyncBlockingChecker(Checker):
    rule = "async-blocking"
    description = "blocking calls inside async def bodies (event-loop stalls)"
    scope = "repo"  # async test/bench helpers stall loops just as well

    def check(self, module: Module) -> list[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.AsyncFunctionDef):
                findings.extend(self._check_async_fn(module, node))
        return findings

    def _check_async_fn(
        self, module: Module, fn: ast.AsyncFunctionDef
    ) -> list[Finding]:
        findings: list[Finding] = []
        for node in self._own_body_walk(fn):
            if isinstance(node, ast.Call):
                f = self._classify(module, fn, node)
                if f is not None:
                    findings.append(f)
        return findings

    @staticmethod
    def _own_body_walk(fn: ast.AsyncFunctionDef):
        """Walk the async function's body without descending into nested
        function definitions: nested async defs are visited on their own
        by `check`, and nested sync defs may target executor threads."""
        stack: list[ast.AST] = [
            stmt
            for stmt in fn.body
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                stack.append(child)

    def _classify(
        self, module: Module, fn: ast.AsyncFunctionDef, call: ast.Call
    ) -> Finding | None:
        func = call.func
        dotted = _dotted(func)
        if dotted:
            hint = _BLOCKING_EXACT.get(dotted)
            if hint is None:
                for prefix, h in _BLOCKING_PREFIXES.items():
                    if dotted.startswith(prefix):
                        hint = h
                        break
            if hint is not None:
                return module.finding(
                    self.rule,
                    call,
                    f"blocking call `{dotted}(...)` inside `async def "
                    f"{fn.name}` stalls the event loop",
                    hint=hint,
                )
        if isinstance(func, ast.Name) and func.id == "open":
            return module.finding(
                self.rule,
                call,
                f"blocking `open()` inside `async def {fn.name}` stalls "
                "the event loop",
                hint="read at startup, or wrap in `asyncio.to_thread`",
            )
        if isinstance(func, ast.Attribute) and func.attr in _STORE_METHODS:
            recv = _store_receiver(func.value)
            if recv is not None:
                return module.finding(
                    self.rule,
                    call,
                    f"sync store call `{recv}.{func.attr}(...)` inside "
                    f"`async def {fn.name}` blocks the event loop on "
                    "store I/O",
                    hint="wrap it: `await asyncio.to_thread("
                    f"{recv}.{func.attr}, ...)`",
                )
        return None
