"""The port's four concurrency rules (`foremast_tpu_torch/analysis/`
`async_blocking.py`, `lock_discipline.py`, `thread_escape.py`,
`blocking_under_lock.py`) after their cases in `tests/test_analysis.py`.

The fixtures are JAX's, with paths and imports mapped from
`foremast_tpu/` to `foremast_tpu_torch/`. Each case asserts what the JAX
case asserts on the port's checker, and a parity test runs every shared
fixture through both packages' rules: the same (rule, line) pairs come
out. The port's own forms have a fixture of their own: a
`Thread(target=self._loop)` worker mutating another class's guarded
state (as the pod's broadcast thread could), and `http.client` under a
lock, which only the port's table of blocking calls names. The tree
cases check that the rules see the port's thread roots, and pin the one
race the rules found in the port's own code (`native.load`)."""

from __future__ import annotations

import shutil
import textwrap
import threading

import pytest

from foremast_tpu.analysis.async_blocking import AsyncBlockingChecker as JaxAsyncBlocking
from foremast_tpu.analysis.blocking_under_lock import apply_suppressions as jax_apply_suppressions
from foremast_tpu.analysis.blocking_under_lock import check_blocking_under_lock as jax_check_blocking
from foremast_tpu.analysis.core import Module as JaxModule
from foremast_tpu.analysis.core import analyze_modules as jax_analyze_modules
from foremast_tpu.analysis.interproc import Program as JaxProgram
from foremast_tpu.analysis.lock_discipline import LockDisciplineChecker as JaxLockDiscipline
from foremast_tpu.analysis.thread_escape import check_thread_escape as jax_check_thread_escape
from foremast_tpu_torch import native
from foremast_tpu_torch.analysis import analyze_source
from foremast_tpu_torch.analysis.async_blocking import AsyncBlockingChecker
from foremast_tpu_torch.analysis.blocking_under_lock import apply_suppressions, check_blocking_under_lock
from foremast_tpu_torch.analysis.core import Module, analyze_modules, collect_modules, repo_root
from foremast_tpu_torch.analysis.interproc import Program
from foremast_tpu_torch.analysis.lock_discipline import LockDisciplineChecker
from foremast_tpu_torch.analysis.thread_escape import check_thread_escape, reachable_functions, thread_roots


def src(text: str) -> str:
    return textwrap.dedent(text)


def _to_jax(text: str) -> str:
    return text.replace("foremast_tpu_torch/", "foremast_tpu/").replace("foremast_tpu_torch.", "foremast_tpu.")


def _program(sources: dict) -> Program:
    return Program([Module(p, src(s)) for p, s in sources.items()])


def _blocking_findings(sources: dict):
    prog = _program(sources)
    return apply_suppressions(check_blocking_under_lock(prog), prog.modules)


ASYNC_PATH = "foremast_tpu_torch/service/fixture.py"
LOCK_PATH = "foremast_tpu_torch/jobs/fixture.py"

# ---------------------------------------------------------------------------
# the shared fixtures: path -> source, or a {path: source} program
# ---------------------------------------------------------------------------

ASYNC_BAD = """
    import time
    import requests

    async def handler(request, store):
        time.sleep(1)
        requests.get("http://upstream")
        store.update(request)
        return open("/etc/hostname").read()
"""

ASYNC_CLEAN = """
    import asyncio
    import time

    async def handler(request, store):
        await asyncio.sleep(1)
        doc = await asyncio.to_thread(store.get, "id")

        def executor_target():
            time.sleep(1)

        return doc
"""

ASYNC_SYNC_ONLY = """
    import time

    def poll_loop():
        time.sleep(5)
"""

LOCK_BAD = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = {}
            self.count = 0

        def put(self, key, value):
            with self._lock:
                self._items[key] = value
                self.count += 1

        def racy_get(self, key):
            return self._items.get(key)

        def racy_reset(self):
            self.count = 0
"""

LOCK_CLEAN = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = {}
            self.limit = 8  # read-only config: never guarded

        def put(self, key, value):
            with self._lock:
                if len(self._items) < self.limit:
                    self._items[key] = value

        def get(self, key):
            with self._lock:
                return self._items.get(key)

        def describe(self):
            return f"box(limit={self.limit})"
"""

LOCK_GLOBALS = """
    import threading

    _lock = threading.Lock()
    _cache = None

    def load():
        global _cache
        with _lock:
            if _cache is None:
                _cache = object()
            return _cache

    def racy_invalidate():
        global _cache
        _cache = None
"""

LOCK_NESTED_DEF = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._flag = False

        def arm(self):
            with self._lock:
                self._flag = True

                def later():
                    self._flag = False

                return later
"""

LOCK_ENV_WRITE = """
    import os

    def adopt(knobs):
        os.environ["FOREMAST_ARENA_BYTES"] = str(knobs[0])
"""

LOCK_WSGI = """
    def app(environ, start_response):
        environ["HTTP_X"] = "1"
        return environ.get("PATH_INFO", "/")
"""

MIXED_GUARD = {
    "foremast_tpu_torch/fix/mix.py": """
        import threading

        class T:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()
                self.stamp = 0.0

            def sched(self):
                with self._a:
                    self.stamp = 1.0

            def flush(self):
                with self._b:
                    self.stamp = 2.0
    """
}

NESTED_LOCKS = {
    "foremast_tpu_torch/fix/nest.py": """
        import threading

        class T:
            def __init__(self):
                self._pass = threading.Lock()
                self._meta = threading.Lock()
                self.count = 0

            def heavy(self):
                with self._pass:
                    with self._meta:
                        self.count += 1

            def light(self):
                with self._meta:
                    self.count += 1
    """
}

THREAD_ESCAPE_SRC = {
    "foremast_tpu_torch/fix/guarded.py": """
        import threading

        class Guarded:
            def __init__(self):
                self._lock = threading.Lock()
                self.hits = 0

            def bump(self):
                with self._lock:
                    self.hits += 1
    """,
    "foremast_tpu_torch/fix/runner.py": """
        import threading

        from foremast_tpu_torch.fix.guarded import Guarded

        class Runner:
            def __init__(self, g: Guarded):
                self.g = g

            def start(self):
                threading.Thread(target=self._loop, daemon=True).start()

            def _loop(self):
                self.g.hits += 1

            def safe_loop(self):
                with self.g._lock:
                    self.g.hits += 1
    """,
}

THREAD_ESCAPE_NO_ROOT = {
    **THREAD_ESCAPE_SRC,
    "foremast_tpu_torch/fix/runner.py": """
        from foremast_tpu_torch.fix.guarded import Guarded

        class Runner:
            def __init__(self, g: Guarded):
                self.g = g

            def _loop(self):
                self.g.hits += 1
    """,
}

THREAD_ESCAPE_CLOSURE = {
    **THREAD_ESCAPE_SRC,
    "foremast_tpu_torch/fix/runner.py": """
        import threading

        from foremast_tpu_torch.fix.guarded import Guarded

        class Runner:
            def __init__(self, g: Guarded):
                self.g = g

            def start(self):
                with self.g._lock:
                    def loop():
                        self.g.hits += 1
                    threading.Thread(target=loop, daemon=True).start()
    """,
}

SURFACE = {
    "foremast_tpu_torch/fix/surface.py": """
        from http.server import BaseHTTPRequestHandler

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                pass

        class StatsCollector:
            def collect(self):
                yield 1

        def wire(registry):
            registry.register(StatsCollector())
    """
}

BLOCKING_DIRECT = {
    "foremast_tpu_torch/fix/blk.py": """
        import threading
        import time

        class Poller:
            def __init__(self):
                self._lock = threading.Lock()

            def bad(self):
                with self._lock:
                    time.sleep(1)

            def good(self):
                with self._lock:
                    x = 1
                time.sleep(1)
                return x
    """
}

BLOCKING_INTERPROC = {
    "foremast_tpu_torch/fix/blk2.py": """
        import threading
        import requests

        def _fetch(url):
            return requests.get(url)

        class Client:
            def __init__(self):
                self._lock = threading.Lock()

            def refresh(self):
                with self._lock:
                    return _fetch("http://upstream")
    """
}

BLOCKING_SUPPRESSED = {
    "foremast_tpu_torch/fix/blk3.py": """
        import threading
        import time

        class Poller:
            def __init__(self):
                self._lock = threading.Lock()

            def deliberate(self):
                with self._lock:
                    # the lock IS the serializer here (fixture)
                    time.sleep(0)  # foremast: ignore[blocking-under-lock]
    """
}

BLOCKING_NESTED_DEF = {
    "foremast_tpu_torch/fix/blk4.py": """
        import threading
        import time

        class Poller:
            def __init__(self):
                self._lock = threading.Lock()

            def sched(self):
                with self._lock:
                    def later():
                        time.sleep(1)
                    return later
    """
}

# the port's own forms: a broadcast thread (`_BroadcastWorker`'s
# `Thread(target=self._loop)` over a queue) writing another class's
# guarded clock, and a probe over `http.client` under its lock
_POD_THREAD = """
        import queue
        import threading

        class Clock:
            def __init__(self):
                self._lock = threading.Lock()
                self.now = 0.0

            def tick(self, t):
                with self._lock:
                    self.now = t

        class BroadcastWorker:
            def __init__(self, clock: Clock):
                self.clock = clock
                self._q = queue.Queue()
                self._thread = threading.Thread(target=self._loop, daemon=True, name="pod-broadcast")
                self._thread.start()

            def _loop(self):
                while True:
                    t = self._q.get()
                    self.clock.now = t
"""
_POD_PROBE = """
        class Probe:
            def __init__(self):
                self._lock = threading.Lock()

            def count(self, host):
                import http.client

                with self._lock:
                    conn = http.client.HTTPConnection(host, timeout=2)
                    conn.request("GET", "/_count")
                    return conn.getresponse().read()
"""
POD_PATH = "foremast_tpu_torch/fix/pod.py"
PORT_FORMS = {POD_PATH: _POD_THREAD + _POD_PROBE}


def _line_of(sources: dict, path: str, text: str) -> int:
    return next(i for i, line in enumerate(src(sources[path]).splitlines(), 1) if text in line)

SHARED = {
    "async_bad": {ASYNC_PATH: ASYNC_BAD},
    "async_clean": {ASYNC_PATH: ASYNC_CLEAN},
    "async_sync_only": {ASYNC_PATH: ASYNC_SYNC_ONLY},
    "lock_bad": {LOCK_PATH: LOCK_BAD},
    "lock_clean": {LOCK_PATH: LOCK_CLEAN},
    "lock_globals": {LOCK_PATH: LOCK_GLOBALS},
    "lock_nested_def": {LOCK_PATH: LOCK_NESTED_DEF},
    "lock_env_write": {LOCK_PATH: LOCK_ENV_WRITE},
    "lock_wsgi": {LOCK_PATH: LOCK_WSGI},
    "mixed_guard": MIXED_GUARD,
    "nested_locks": NESTED_LOCKS,
    "thread_escape": THREAD_ESCAPE_SRC,
    "thread_escape_no_root": THREAD_ESCAPE_NO_ROOT,
    "thread_escape_closure": THREAD_ESCAPE_CLOSURE,
    "surface": SURFACE,
    "blocking_direct": BLOCKING_DIRECT,
    "blocking_interproc": BLOCKING_INTERPROC,
    "blocking_suppressed": BLOCKING_SUPPRESSED,
    "blocking_nested_def": BLOCKING_NESTED_DEF,
    "port_forms_thread": {POD_PATH: _POD_THREAD},
}


def port_pairs(sources: dict) -> set[tuple[str, str, int]]:
    """(rule, path, line) of the port's four rules over a fixture."""
    modules = [Module(p, src(s)) for p, s in sources.items()]
    found = analyze_modules(modules, [AsyncBlockingChecker(), LockDisciplineChecker()])
    prog = Program(modules)
    found += apply_suppressions(check_thread_escape(prog) + check_blocking_under_lock(prog), modules)
    return {(f.rule, f.path, f.line) for f in found}


def jax_pairs(sources: dict) -> set[tuple[str, str, int]]:
    """The same through the JAX package's rules, paths mapped back."""
    modules = [JaxModule(_to_jax(p), src(_to_jax(s))) for p, s in sources.items()]
    found = jax_analyze_modules(modules, [JaxAsyncBlocking(), JaxLockDiscipline()])
    prog = JaxProgram(modules)
    found += jax_apply_suppressions(jax_check_thread_escape(prog) + jax_check_blocking(prog), modules)
    return {(f.rule, f.path.replace("foremast_tpu/", "foremast_tpu_torch/"), f.line) for f in found}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_parity_with_the_jax_rules(name):
    assert port_pairs(SHARED[name]) == jax_pairs(SHARED[name])


# ---------------------------------------------------------------------------
# async-blocking
# ---------------------------------------------------------------------------


def test_async_blocking_catches_each_violation_class():
    findings = analyze_source(src(ASYNC_BAD), ASYNC_PATH, [AsyncBlockingChecker()])
    messages = "\n".join(f.message for f in findings)
    assert "`time.sleep(...)`" in messages
    assert "`requests.get(...)`" in messages
    assert "`store.update(...)`" in messages
    assert "`open()`" in messages
    assert len(findings) == 4


def test_async_blocking_permits_to_thread_and_nested_sync_defs():
    assert analyze_source(src(ASYNC_CLEAN), ASYNC_PATH, [AsyncBlockingChecker()]) == []


def test_async_blocking_ignores_sync_functions():
    assert analyze_source(src(ASYNC_SYNC_ONLY), ASYNC_PATH, [AsyncBlockingChecker()]) == []


def test_async_blocking_covers_the_port_tests():
    """Repo-scoped: a port test's coroutine is held to it as well."""
    assert len(analyze_source(src(ASYNC_BAD), "tests/test_torch_fixture.py", [AsyncBlockingChecker()])) == 4


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------


def _lock(source: str):
    return analyze_source(src(source), LOCK_PATH, [LockDisciplineChecker()])


def test_lock_discipline_flags_unlocked_access():
    findings = _lock(LOCK_BAD)
    messages = "\n".join(f.message for f in findings)
    assert "unlocked read of `self._items` in `Box.racy_get`" in messages
    assert "unlocked write to `self.count` in `Box.racy_reset`" in messages
    assert len(findings) == 2


def test_lock_discipline_clean_class_and_readonly_config():
    assert _lock(LOCK_CLEAN) == []


def test_lock_discipline_module_level_globals():
    findings = _lock(LOCK_GLOBALS)
    assert len(findings) == 1
    assert "module global `_cache` in `racy_invalidate`" in findings[0].message


def test_lock_discipline_nested_def_does_not_inherit_lock():
    findings = _lock(LOCK_NESTED_DEF)
    assert len(findings) == 1
    assert "unlocked write to `self._flag`" in findings[0].message


def test_lock_discipline_flags_runtime_env_writes():
    findings = _lock(LOCK_ENV_WRITE)
    assert len(findings) == 1
    assert "mutates process env at runtime" in findings[0].message


def test_lock_discipline_wsgi_environ_dict_is_not_process_env():
    assert _lock(LOCK_WSGI) == []


def test_lock_discipline_skips_the_port_tests():
    assert analyze_source(src(LOCK_BAD), "tests/test_torch_fixture.py", [LockDisciplineChecker()]) == []


# ---------------------------------------------------------------------------
# thread-escape
# ---------------------------------------------------------------------------


def test_thread_escape_closure_under_lock_is_not_guard_evidence():
    """A thread-target closure DEFINED inside a locked region runs
    unlocked: its mutation is no guard evidence, and the unlocked
    mutation of guarded state is still flagged."""
    findings = check_thread_escape(_program(THREAD_ESCAPE_CLOSURE))
    assert len(findings) == 1
    assert "Guarded.hits" in findings[0].message


def test_thread_escape_mixed_guard():
    findings = check_thread_escape(_program(MIXED_GUARD))
    assert len(findings) == 1
    assert "T.stamp" in findings[0].message
    assert "DIFFERENT locks" in findings[0].message


def test_thread_escape_nested_locks_are_not_mixed_guard():
    assert check_thread_escape(_program(NESTED_LOCKS)) == []


def test_thread_escape_cross_module_unlocked_mutation():
    findings = check_thread_escape(_program(THREAD_ESCAPE_SRC))
    assert len(findings) == 1
    f = findings[0]
    assert f.path == "foremast_tpu_torch/fix/runner.py"
    assert "Guarded.hits" in f.message and "Runner._loop" in f.message


def test_thread_escape_needs_a_thread_root():
    assert check_thread_escape(_program(THREAD_ESCAPE_NO_ROOT)) == []


def test_thread_escape_roots_include_handlers_and_collectors():
    names = {f.qualname for f in thread_roots(_program(SURFACE))}
    assert "Handler.do_GET" in names
    assert "StatsCollector.collect" in names


def test_thread_escape_broadcast_worker_form():
    """The pod's broadcast-thread shape: a `Thread(target=self._loop)`
    started in `__init__`, its loop writing another class's guarded
    attribute without that class's lock."""
    findings = check_thread_escape(_program(PORT_FORMS))
    assert len(findings) == 1
    f = findings[0]
    assert "`Clock.now` is guarded by Clock._lock" in f.message and "BroadcastWorker._loop" in f.message
    assert f.line == _line_of(PORT_FORMS, POD_PATH, "self.clock.now = t")


def test_thread_escape_reaches_overrides_and_handler_closures():
    """A root reaches the subclasses' overrides of a base-typed call and
    the closures a handler class calls from the function that built it:
    the shapes of the port's varz (`self.store.count_open()` on a
    `JobStore`) and `ThreadingHTTPServer` handlers."""
    prog = _program({
        "foremast_tpu_torch/fix/srv.py": """
            from http.server import BaseHTTPRequestHandler

            class Store:
                def count(self):
                    return 0

            class LeaderStore(Store):
                def count(self):
                    return 1

            class Worker:
                def __init__(self, store: Store):
                    self.store = store

                def state(self):
                    return self.store.count()

            def start():
                def answer():
                    worker = Worker(LeaderStore())
                    return worker.state()

                class Handler(BaseHTTPRequestHandler):
                    def do_GET(self):
                        answer()

                return Handler
        """
    })
    reached = {f.qualname for f in reachable_functions(prog, thread_roots(prog))}
    assert {"start.Handler.do_GET", "start.answer", "Worker.state", "Store.count", "LeaderStore.count"} <= reached


def test_thread_escape_sees_the_port_thread_roots():
    """On the port's tree: the `ThreadingHTTPServer` handlers of the
    gateway (and the dashboard, served by the same `make_server`),
    the receiver and the observe server; the pod's broadcast loop; and
    the varz path that answers `LeaderStore.count_open` on the observe
    thread."""
    root = repo_root()
    prog = Program(collect_modules(root))
    roots = thread_roots(prog)
    names = {(f.module.relpath, f.qualname) for f in roots}
    for rel in ("service/app.py", "ingest/receiver.py", "observe/spans.py"):
        assert any(p == f"foremast_tpu_torch/{rel}" and q.endswith("Handler.do_GET") for p, q in names), rel
    assert ("foremast_tpu_torch/parallel/distributed.py", "_BroadcastWorker._loop") in names
    reached = {f.qualname for f in reachable_functions(prog, roots)}
    assert {"Gateway.handle", "BrainWorker.debug_state", "LeaderStore.count_open",
            "ElasticsearchStore.count_open", "RingShard.push_many"} <= reached
    assert check_thread_escape(prog) == []


# ---------------------------------------------------------------------------
# blocking-under-lock
# ---------------------------------------------------------------------------


def test_blocking_under_lock_nested_def_not_attributed_inline():
    assert _blocking_findings(BLOCKING_NESTED_DEF) == []


def test_blocking_under_lock_direct_and_clean():
    findings = _blocking_findings(BLOCKING_DIRECT)
    assert len(findings) == 1
    assert "time.sleep" in findings[0].message
    assert "Poller.bad" in findings[0].message


def test_blocking_under_lock_interprocedural():
    msgs = "\n".join(f.message for f in _blocking_findings(BLOCKING_INTERPROC))
    assert "_fetch" in msgs and "HTTP call" in msgs
    assert "Client.refresh" in msgs


def test_blocking_under_lock_suppression_in_place():
    assert _blocking_findings(BLOCKING_SUPPRESSED) == []


def test_blocking_under_lock_http_client_form():
    """`http.client` is the port's HTTP transport: the only entry its
    table adds to JAX's, so the JAX rule passes this line and the port's
    flags it."""
    line = _line_of(PORT_FORMS, POD_PATH, "http.client.HTTPConnection(")
    findings = _blocking_findings(PORT_FORMS)
    assert [(f.line, "`http.client.HTTPConnection`" in f.message, "Probe.count" in f.message)
            for f in findings] == [(line, True, True)]
    assert port_pairs(PORT_FORMS) - jax_pairs(PORT_FORMS) == {("blocking-under-lock", POD_PATH, line)}
    assert jax_pairs(PORT_FORMS) <= port_pairs(PORT_FORMS)


# ---------------------------------------------------------------------------
# the fault the rules found: `native.load` read its state past the lock
# ---------------------------------------------------------------------------


def test_native_load_waits_for_a_racing_build(monkeypatch, tmp_path):
    """`load()` marks itself tried before the build and publishes the
    library after it. A second caller that read that flag outside the
    lock took the numpy loops while the first was still building; every
    read is under the lock now, so the second caller waits for the
    library and gets it."""
    if native.load() is None:
        pytest.fail(f"the native library does not build here: {native.error()}")
    built = native._lib_path()
    target = tmp_path / "libforemast_native-race.so"
    started, release = threading.Event(), threading.Event()

    def slow_build(out):
        started.set()
        assert release.wait(30)
        shutil.copyfile(built, out)

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_lib_path", lambda: target)
    monkeypatch.setattr(native, "_build", slow_build)
    got = {}
    first = threading.Thread(target=lambda: got.setdefault("first", native.load()))
    first.start()
    try:
        assert started.wait(30)
        second = threading.Thread(target=lambda: got.setdefault("second", native.load()))
        second.start()
        second.join(0.5)
        assert second.is_alive(), "load() returned while another thread was building the library"
    finally:
        release.set()
        first.join(30)
    second.join(30)
    assert got["first"] is not None and got["second"] is got["first"]
