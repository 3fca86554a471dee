"""The port's env registry (`foremast_tpu_torch/config.py` `ENV_KNOBS`,
`env_overrides`) and env contract
(`foremast_tpu_torch/analysis/env_contract.py`) against the JAX
package's.

Every knob both packages register is the same knob (name, default, kind,
group); the JAX knobs the port leaves out are exactly the listed ones,
and the port's own are the build's `CUDA_HOME` and `CXX`. The contract's
rules are JAX's (`tests/test_analysis.py`'s env cases run on the port's
checker), the port's tree has no unregistered or computed read, the
README's knob table is current, and the port worker's
`/debug/state` `env_overrides` equals the JAX worker's under one
environment."""

from __future__ import annotations

import ast
import os
import pathlib
import re
import textwrap

import pytest

import foremast_tpu.config as JC
import foremast_tpu_torch.config as PC
from foremast_tpu.analysis import analyze_source
from foremast_tpu.analysis.env_contract import EnvContractChecker
from foremast_tpu_torch.analysis import env_contract as EC
from foremast_tpu_torch.analysis.core import Module

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_ONLY = {"CUDA_HOME", "CXX"}
# JAX knobs the port never reads: the fused Pallas judgment, XLA's
# compilation cache and the JAX benchmarks' round
JAX_ONLY = {"FOREMAST_PALLAS", "FOREMAST_COMPILE_CACHE_DIR", "FOREMAST_BENCH_ROUND"}
ENV_PATH = "foremast_tpu_torch/engine/fixture_env.py"
GOOD = frozenset({"GOOD_KNOB"})


def src(text: str) -> str:
    return textwrap.dedent(text)


def port_findings(source: str, relpath: str = ENV_PATH, names=GOOD):
    """The port's checker over one fixture source, suppressions applied
    (the path `env_findings` takes for each file of the tree)."""
    if relpath in EC.EXEMPT:
        return []
    module = Module(relpath, source)
    return sorted((f for f in EC.check_module(module, names) if not module.suppressed(f.line, f.rule)),
                  key=lambda f: f.sort_key())


def jax_findings(source: str, relpath: str = "foremast_tpu/engine/fixture_env.py", names=GOOD):
    return analyze_source(source, relpath, [EnvContractChecker(names=names)])


def test_shared_knobs_equal_jax():
    jax = {k.name: k for k in JC.ENV_KNOBS}
    port = {k.name: k for k in PC.ENV_KNOBS}
    shared = set(jax) & set(port)
    assert set(port) - shared == PORT_ONLY
    assert set(jax) - shared == JAX_ONLY
    for name in shared:
        j, p = jax[name], port[name]
        assert (p.name, p.default, p.kind, p.group) == (j.name, j.default, j.kind, j.group), name
    # registry order follows JAX's for the shared knobs
    assert [n for n in (k.name for k in PC.ENV_KNOBS) if n in shared] == [
        n for n in (k.name for k in JC.ENV_KNOBS) if n in shared]


def test_registry_names_unique_and_real():
    names = [k.name for k in PC.ENV_KNOBS]
    assert len(names) == len(set(names)) and PC.ENV_KNOB_NAMES == frozenset(names)
    for knob in PC.ENV_KNOBS:
        assert knob.description
        assert knob.group in ("engine", "framework", "deploy")
        assert knob.kind in ("str", "int", "float", "bool", "path", "indexed")
    assert {k.group for k in PC.ENV_KNOBS if k.name in PORT_ONLY} == {"deploy"}


def test_port_tree_reads_only_registered_knobs():
    findings = EC.env_findings()
    assert findings == [], "\n".join(f.render() for f in findings)


def test_every_env_like_literal_of_the_port_is_registered():
    """Reads through a parameter (`e = os.environ if env is None else
    env; e.get(...)`) are outside the contract's AST rule, as they are in
    JAX's; every FOREMAST_* literal of the port is registered all the
    same."""
    seen = set()
    for path in (ROOT / "foremast_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                if re.fullmatch(r"FOREMAST_[A-Z0-9_]+", node.value):
                    seen.add(node.value)
    assert len(seen) > 60
    assert seen <= PC.ENV_KNOB_NAMES, sorted(seen - PC.ENV_KNOB_NAMES)


_FLAGGED = src(
    """
    import os

    def configure(name):
        a = os.environ.get("GOOD_KNOB")
        b = os.environ.get("BAD_KNOB", "1")
        c = os.environ["ALSO_BAD"]
        d = os.environ.get(name)
        return a, b, c, d
    """
)


def test_env_contract_flags_unregistered_and_dynamic_reads():
    findings = port_findings(_FLAGGED)
    messages = "\n".join(f.message for f in findings)
    assert "'BAD_KNOB'" in messages and "'ALSO_BAD'" in messages
    assert "computed name" in messages and "GOOD_KNOB" not in messages
    assert len(findings) == 3
    assert [(f.line, f.message) for f in findings] == [(f.line, f.message) for f in jax_findings(_FLAGGED)]


def test_env_contract_exempts_config_and_wsgi_dicts():
    source = 'import os\nx = os.environ.get("ANYTHING")\n'
    assert port_findings(source, "foremast_tpu_torch/config.py") == []
    wsgi = src(
        """
        def app(environ, start_response):
            return environ.get("PATH_INFO"), environ.get("REQUEST_METHOD")
        """
    )
    assert port_findings(wsgi) == [] == jax_findings(wsgi)


def test_env_contract_from_import_alias_counts():
    source = src(
        """
        from os import environ, getenv

        def f():
            return environ.get("BAD_KNOB"), environ["WORSE"], getenv("WORST")
        """
    )
    assert len(port_findings(source)) == 3 == len(jax_findings(source))


def test_env_contract_suppression_on_the_line_or_above():
    source = src(
        """
        import os

        def f(name):
            a = os.environ.get(name)  # foremast: ignore[env-contract]
            # foremast: ignore[env-contract]
            b = os.environ.get(name)
            c = os.environ.get(name)  # foremast: ignore[other-rule]
            return a, b, c
        """
    )
    findings = port_findings(source)
    assert [f.line for f in findings] == [8]
    assert [f.line for f in jax_findings(source)] == [8]


def test_env_findings_over_a_fixture_tree(tmp_path):
    pkg = tmp_path / "foremast_tpu_torch"
    pkg.mkdir()
    (pkg / "bad.py").write_text(_FLAGGED)
    (pkg / "config.py").write_text('import os\nx = os.environ.get("ANYTHING")\n')
    findings = EC.env_findings(names=GOOD, root=str(tmp_path))
    assert {f.path for f in findings} == {"foremast_tpu_torch/bad.py"} and len(findings) == 3


def test_env_overrides_enumerates_set_knobs(monkeypatch):
    monkeypatch.setenv("FOREMAST_ARENA_BYTES", "4096")
    monkeypatch.delenv("FOREMAST_BF16_DELTA", raising=False)
    over = PC.env_overrides()
    assert over["FOREMAST_ARENA_BYTES"] == "4096"
    assert "FOREMAST_BF16_DELTA" not in over
    env = {"ML_ALGORITHM": "ewma", "CXX": "clang++", "NOT_A_KNOB": "1", "FOREMAST_PALLAS": "1"}
    assert PC.env_overrides(env) == {"ML_ALGORITHM": "ewma", "CXX": "clang++"}
    assert JC.env_overrides(env) == {"ML_ALGORITHM": "ewma", "FOREMAST_PALLAS": "1"}


def test_env_docs_block_in_sync_with_registry():
    assert EC.check_env_docs() == []
    text = (ROOT / "README.md").read_text()
    assert EC.env_table() in text
    for knob in PC.ENV_KNOBS:
        assert f"| `{knob.name}` |" in EC.env_table()


def test_stale_env_docs_block_is_a_finding(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text("# x\n")
    assert "markers missing" in EC.check_env_docs(str(tmp_path))[0].message
    readme.write_text(f"# x\n{EC.DOCS_BEGIN}\nold\n{EC.DOCS_END}\n")
    assert "stale" in EC.check_env_docs(str(tmp_path))[0].message
    assert EC.update_env_docs(str(tmp_path)) is True
    assert EC.check_env_docs(str(tmp_path)) == []
    assert EC.update_env_docs(str(tmp_path)) is False


SHARED_ENV = {
    "FOREMAST_ARENA_BYTES": "8388608",
    "FOREMAST_FETCH_WORKERS": "4",
    "ML_THRESHOLD": "2.0",
    "FOREMAST_SWEEP_SLICE_DOCS": "0",
}


def test_debug_state_env_overrides_equal_jax(monkeypatch):
    from tests.torch_workers import worker_pair

    for name in list(os.environ):
        if name in PC.ENV_KNOB_NAMES or name in JC.ENV_KNOB_NAMES:
            monkeypatch.delenv(name)
    for name, value in SHARED_ENV.items():
        monkeypatch.setenv(name, value)
    (jw, _, _), (pw, _, _) = worker_pair(2)
    try:
        jstate, pstate = jw.debug_state(), pw.debug_state()
    finally:
        jw.close()
        pw.close()
    assert pstate["env_overrides"] == jstate["env_overrides"] == SHARED_ENV
