"""The port's static lock graph (`foremast_tpu_torch/analysis/interproc.py`,
`lock_order.py`, committed as `analysis_lockgraph_torch.json`) and its
runtime lock witness (`analysis/witness.py`), after the lock-order and
witness cases of `tests/test_analysis.py`.

The fixture programs are JAX's, under the port's package prefix, and
give the same graphs through both resolvers. The committed graph is
current and cycle-free, and its edges, by node id, are exactly
`analysis_lockgraph.json`'s: the port nests its locks only in orders the
JAX package also has (`EDGES_ONLY_IN_JAX` and `EDGES_ONLY_IN_PORT` are
empty). Its one extra node is the kernel build's module lock
(`ops._build._lock`), a leaf."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np

from foremast_tpu.analysis.core import Module as JaxModule
from foremast_tpu.analysis.interproc import Program as JaxProgram
from foremast_tpu.analysis.lock_order import build_graph as jax_build_graph
from foremast_tpu_torch.analysis import witness
from foremast_tpu_torch.analysis.core import Module, collect_modules, repo_root
from foremast_tpu_torch.analysis.interproc import Program, module_stem
from foremast_tpu_torch.analysis.lock_order import (
    GRAPH_NAME,
    build_graph,
    check_lock_order,
    find_cycles,
    load_graph,
    write_graph,
)

ROOT = Path(__file__).resolve().parent.parent
# edges of one package's graph the other lacks, each with its reason
EDGES_ONLY_IN_JAX: dict[tuple[str, str], str] = {}
EDGES_ONLY_IN_PORT: dict[tuple[str, str], str] = {}
PORT_ONLY_NODES = {
    "ops._build._lock": "the port's kernel build (ops/_build.py), a leaf",
    "Tracer._roots_lock": "the port's tracer's open roots, read by its gc hook (observe/spans.py), a leaf",
    "observe.spans._GC_HOOK_LOCK": "the port's one gc.callbacks entry a process (observe/spans.py), a leaf",
}


def src(text: str) -> str:
    return textwrap.dedent(text)


def _program(sources: dict) -> Program:
    return Program([Module(p, src(s)) for p, s in sources.items()])


def _both(sources: dict) -> tuple[dict, dict]:
    """(port graph, JAX graph) of one fixture program: the port's
    resolver over `foremast_tpu_torch/...` paths, JAX's over the same
    sources under `foremast_tpu/...`."""
    port = build_graph(_program(sources))
    jax_sources = {p.replace("foremast_tpu_torch/", "foremast_tpu/"): s.replace("foremast_tpu_torch.", "foremast_tpu.")
                   for p, s in sources.items()}
    jax = jax_build_graph(JaxProgram([JaxModule(p, src(s)) for p, s in jax_sources.items()]))
    return port, jax


def _edge_set(graph: dict) -> set[tuple[str, str]]:
    return {(e["from"], e["to"]) for e in graph["edges"]}


LOCK_ORDER_NESTED = {
    "foremast_tpu_torch/fix/a.py": """
        import threading

        from foremast_tpu_torch.fix.b import Inner

        class Outer:
            def __init__(self, inner: Inner):
                self._lock = threading.Lock()
                self.inner = inner

            def work(self):
                with self._lock:
                    self.inner.poke()

            def hook_up(self, sink):
                sink.on_data = self.inner.poke
    """,
    "foremast_tpu_torch/fix/b.py": """
        import threading

        class Inner:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def poke(self):
                with self._lock:
                    self.n += 1

        class Sink:
            def __init__(self):
                self._lock = threading.Lock()
                self.on_data = None

            def deliver(self):
                with self._lock:
                    on_data = self.on_data
                    on_data()
    """,
}


def test_module_stem_strips_the_port_prefix():
    assert module_stem("foremast_tpu_torch/observe/spans.py") == "observe.spans"
    assert module_stem("foremast_tpu_torch/ingest/__init__.py") == "ingest"
    assert module_stem("foremast_tpu_torch/native.py") == "native"


def test_lock_order_graph_interprocedural_edges():
    """Nesting through a TYPED attribute call, and a CALLBACK registered
    by attribute assignment in another module, both become edges; the
    JAX resolver gives the same graph."""
    g, jg = _both(LOCK_ORDER_NESTED)
    assert {"Outer._lock", "Inner._lock", "Sink._lock"} <= {n["id"] for n in g["nodes"]}
    edges = _edge_set(g)
    assert ("Outer._lock", "Inner._lock") in edges  # typed-attr call
    assert ("Sink._lock", "Inner._lock") in edges  # callback table
    assert edges == _edge_set(jg)
    assert [n["site"].replace("foremast_tpu_torch/", "foremast_tpu/") for n in g["nodes"]] == [
        n["site"] for n in jg["nodes"]]


def test_lock_order_cycle_is_a_finding(tmp_path):
    prog = _program(
        {
            "foremast_tpu_torch/fix/cycle.py": """
                import threading

                class A:
                    def __init__(self, b: "B"):
                        self._lock = threading.Lock()
                        self.b = b

                    def fwd(self):
                        with self._lock:
                            self.b.take()

                    def take(self):
                        with self._lock:
                            pass

                class B:
                    def __init__(self, a: A):
                        self._lock = threading.Lock()
                        self.a = a

                    def take(self):
                        with self._lock:
                            pass

                    def back(self):
                        with self._lock:
                            self.a.take()
            """
        }
    )
    g = build_graph(prog)
    assert find_cycles(g), "A->B and B->A must form a cycle"
    write_graph(str(tmp_path), g)  # artifact in sync: only the cycle fires
    findings = check_lock_order(str(tmp_path), prog)
    assert len(findings) == 1
    assert "lock-order cycle" in findings[0].message
    assert "A._lock" in findings[0].message and "B._lock" in findings[0].message
    assert findings[0].path == "foremast_tpu_torch/fix/cycle.py"


def test_lock_order_nested_def_does_not_inherit_lock_context():
    """A call inside a def DEFINED under `with lock:` runs later, maybe on
    another thread: no edge at the definition site."""
    sources = {
        "foremast_tpu_torch/fix/nested.py": """
            import threading

            class B:
                def __init__(self):
                    self._lock = threading.Lock()

                def poke(self):
                    with self._lock:
                        pass

            class A:
                def __init__(self, b: B):
                    self._lock = threading.Lock()
                    self.b = b

                def sched(self):
                    with self._lock:
                        def task():
                            self.b.poke()
                        return task
        """
    }
    g, jg = _both(sources)
    assert ("A._lock", "B._lock") not in _edge_set(g)
    assert _edge_set(g) == _edge_set(jg)


def test_lock_order_rlock_reentrancy_is_not_a_cycle():
    sources = {
        "foremast_tpu_torch/fix/rl.py": """
            import threading

            class Cache:
                def __init__(self):
                    self._lock = threading.RLock()

                def get(self):
                    with self._lock:
                        return self._fill()

                def _fill(self):
                    with self._lock:
                        return 1
        """
    }
    g, jg = _both(sources)
    assert find_cycles(g) == []
    assert [r["id"] for r in g["reentrant"]] == ["Cache._lock"] == [r["id"] for r in jg["reentrant"]]


def test_lock_order_plain_lock_self_deadlock_is_a_cycle():
    prog = _program(
        {
            "foremast_tpu_torch/fix/dead.py": """
                import threading

                class Box:
                    def __init__(self):
                        self._lock = threading.Lock()

                    def outer(self):
                        with self._lock:
                            self.inner()

                    def inner(self):
                        with self._lock:
                            pass
            """
        }
    )
    assert find_cycles(build_graph(prog)) == [["Box._lock", "Box._lock"]]


def test_lockgraph_artifact_roundtrip_and_staleness(tmp_path):
    prog = _program(LOCK_ORDER_NESTED)
    g = build_graph(prog)
    root = str(tmp_path)
    assert any("missing" in f.message for f in check_lock_order(root, prog))
    write_graph(root, g)
    assert load_graph(root) == g
    assert check_lock_order(root, prog) == []
    stale = dict(g)
    stale["edges"] = g["edges"][1:]
    (tmp_path / GRAPH_NAME).write_text(json.dumps(stale))
    assert any("stale" in f.message for f in check_lock_order(root, prog))


def test_tree_lockgraph_committed_in_sync_and_cycle_free():
    root = repo_root()
    assert root == str(ROOT)
    program = Program(collect_modules(root))
    assert check_lock_order(root, program) == []
    graph = load_graph(root)
    assert graph is not None and find_cycles(graph) == []
    assert set(graph) == {"version", "comment", "nodes", "edges", "reentrant"}
    assert all(n["site"].startswith("foremast_tpu_torch/") for n in graph["nodes"])
    edges = _edge_set(graph)
    assert ("RingShard._lock", "_ShardLog._lock") in edges
    assert ("InMemoryStore._lock", "MeshRouter._lock") in edges


def test_graph_edges_equal_jax_graph():
    """Every acquisition order of the port is one the JAX package also
    has, and the other way round; node ids equal apart from the port's
    own build lock."""
    port = load_graph(repo_root())
    jax = json.loads((ROOT / "analysis_lockgraph.json").read_text())
    pe, je = _edge_set(port), _edge_set(jax)
    assert {e: EDGES_ONLY_IN_PORT[e] for e in pe - je} == EDGES_ONLY_IN_PORT
    assert {e: EDGES_ONLY_IN_JAX[e] for e in je - pe} == EDGES_ONLY_IN_JAX
    pn = {n["id"]: n["kind"] for n in port["nodes"]}
    jn = {n["id"]: n["kind"] for n in jax["nodes"]}
    assert set(pn) - set(jn) == set(PORT_ONLY_NODES) and set(jn) <= set(pn)
    assert {k: pn[k] for k in jn} == jn
    assert [r["id"] for r in port["reentrant"]] == [r["id"] for r in jax["reentrant"]]
    assert not any(e[0] in PORT_ONLY_NODES or e[1] in PORT_ONLY_NODES for e in pe)


def test_module_main_checks_the_tree():
    out = subprocess.run([sys.executable, "-m", "foremast_tpu_torch.analysis"], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout


# ---------------------------------------------------------------------------
# the runtime witness
# ---------------------------------------------------------------------------


def test_witness_observes_ordered_fixture_and_matches_graph(tmp_path):
    """The ring journal hook nests `_ShardLog._lock` under
    `RingShard._lock` on a real push: the witness observes that edge, the
    committed graph has it, and a graph without it is reported."""
    from foremast_tpu_torch.ingest import RingSnapshotter, RingStore

    wit = witness.install()
    try:
        store = RingStore(shards=1)
        snap = RingSnapshotter(store, str(tmp_path))
        snap.attach()
        t = np.arange(0, 300, 60, np.int64)
        store.push('m{app="w"}', t, np.ones(len(t), np.float32), start=0.0, now=300.0)
        snap.close()
    finally:
        witness.uninstall()
    observed = wit.edges()
    assert any(a.startswith("foremast_tpu_torch/ingest/shards.py") and
               b.startswith("foremast_tpu_torch/ingest/snapshot.py") for a, b in observed), observed
    graph = witness.load_graph()
    assert graph is not None
    assert wit.unobserved_edges(graph) == []
    doctored = dict(graph)
    doctored["edges"] = [e for e in graph["edges"] if (e["from"], e["to"]) != ("RingShard._lock", "_ShardLog._lock")]
    assert ("RingShard._lock", "_ShardLog._lock") in wit.unobserved_edges(doctored)


def test_witness_reentrant_rlock_records_no_self_edge():
    from foremast_tpu_torch.models.cache import ModelCache

    wit = witness.install()
    try:
        cache = ModelCache(max_size=4)
        cache.restore_lazy({("k", "m"): 1})
        assert cache.get(("k", "m")) == 1  # locked get -> locked rehydrate
    finally:
        witness.uninstall()
    site = "foremast_tpu_torch/models/cache.py"
    assert not any(a.startswith(site) and b.startswith(site) for a, b in wit.edges())


def test_witness_ignores_non_package_locks():
    wit = witness.install()
    try:
        outer = threading.Lock()  # created HERE: a tests/ frame
        inner = threading.Lock()
        with outer:
            with inner:
                pass
        assert not hasattr(outer, "site")
        assert wit.edges() == set()
    finally:
        witness.uninstall()
    assert not isinstance(threading.Lock(), witness._WitnessLockBase)  # uninstalled: raw again


def test_witness_ignores_jax_package_locks():
    """The JAX package's locks are not the port's: raw, even while the
    port's witness is installed."""
    from foremast_tpu.ingest import RingStore as JaxRing

    wit = witness.install()
    try:
        ring = JaxRing(shards=1)
        t = np.arange(0, 300, 60, np.int64)
        ring.push('m{app="w"}', t, np.ones(len(t), np.float32), start=0.0, now=300.0)
        assert not any(isinstance(s._lock, witness._WitnessLockBase) for s in ring._shards)
    finally:
        witness.uninstall()
    assert wit.edges() == set()


def test_install_from_env_is_off_unless_asked():
    assert witness.install_from_env({}) is None
    assert witness.install_from_env({"FOREMAST_LOCK_WITNESS": "0"}) is None
    assert witness.current() is None
