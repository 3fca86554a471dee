"""The port stands alone: no module of `foremast_tpu_torch` and no line of
`chip_smoke.py` imports JAX, the JAX package, scipy, optax or ml_dtypes
(the host quantiles the JAX package takes from scipy are
`torch.special.ndtri` and `ops/quantiles.py` here, Adam is written out,
bf16 goes through torch),
and no module of the port imports `requests`, `prometheus_client`,
`aiohttp` or `yaml` when it is imported (the card's machine lacks the
first two, and no record shows it has the other two: the gateway and the
watch plane serve and call with the standard library).

`tests/torch_fake_services.py`, the fake Elasticsearch and Prometheus
that `chip_smoke.py` serves on the card's machine, is held to the same
rules. The import check runs in a fresh interpreter (`-I`: no site
hooks, no PYTHONPATH), because this test process has JAX loaded
already."""

import ast
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "foremast_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import foremast_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "foremast_tpu_torch.")]
sys.path.insert(0, {tests!r})
names.append("torch_fake_services")
for name in names:
    importlib.import_module(name)
assert "foremast_tpu_torch.cli" in names and "foremast_tpu_torch.__main__" in names
for name in ("jobs.convert", "service.app", "watch.crds", "watch.kubeapi", "watch.analyst", "watch.barrelman",
             "watch.controller", "watch.plane", "reactive.watchstream", "instrument.starter", "demo.app",
             "demo.__main__", "metrics.rules", "ui.join", "ui.metrics", "ui.app", "deploy", "deploy.manifests",
             "deploy.__main__", "analysis", "analysis.core", "analysis.interproc", "analysis.lock_order",
             "analysis.env_contract", "analysis.witness", "analysis.__main__", "analysis.async_blocking",
             "analysis.lock_discipline", "analysis.thread_escape", "analysis.blocking_under_lock",
             "analysis.metrics_contract", "analysis.sharding_contract", "analysis.status_machine",
             "analysis.device_flow",
             "observe.metrics_lint",
             "observe.profile", "parallel.distributed"):
    assert "foremast_tpu_torch." + name in names, name
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "foremast_tpu", "scipy", "optax", "ml_dtypes", "requests",
                           "prometheus_client", "aiohttp", "yaml")
)
print(len(names), bad)
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-I", "-c", _IMPORT_ALL.format(root=str(ROOT), tests=str(ROOT / "tests"))],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 32  # every module of the port was imported
    assert bad == "[]"


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                roots.add(arg.value.split(".")[0])
    return roots


def test_no_source_of_the_port_imports_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_fake_services.py"]
    assert len(files) >= 34
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "foremast_tpu", "scipy", "optax", "ml_dtypes"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


_CONTROL_PLANE = """
import sys
sys.path.insert(0, {root!r})
for name in ("foremast_tpu_torch.cli", "foremast_tpu_torch.service.app", "foremast_tpu_torch.watch.plane",
             "foremast_tpu_torch.reactive.watchstream", "foremast_tpu_torch.jobs.convert"):
    __import__(name)
print("torch" in sys.modules)
"""


def test_gateway_and_watch_plane_start_without_torch():
    """`serve`, `watch`, `unwatch` and `watch-plane` never touch the card:
    their modules import no torch (the jobs package loads its worker on
    first use), so the controller and gateway processes start fast."""
    out = subprocess.run(
        [sys.executable, "-I", "-c", _CONTROL_PLANE.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


_NO_PROMETHEUS_CLIENT = """
import json, sys
sys.path.insert(0, {root!r})
sys.modules["prometheus_client"] = None  # `import prometheus_client` raises ImportError
from foremast_tpu_torch.cli import main
from foremast_tpu_torch.jobs.store import InMemoryStore
from foremast_tpu_torch.service.app import Gateway
from foremast_tpu_torch.watch.kubeapi import HttpKube, InMemoryKube
from foremast_tpu_torch.watch.plane import WatchPlane

body = {{"appName": "shop", "startTime": "2020-09-13T12:26:40Z", "endTime": "2020-09-13T12:36:40Z",
        "strategy": "rollover", "metrics": {{"current": {{"latency": {{"dataSourceType": "prometheus", "parameters": {{
            "endpoint": "http://prometheus:9090/api/v1/", "query": "q", "start": "1", "end": "2", "step": "60"}}}}}}}}}}
g = Gateway(store=InMemoryStore())
codes = [g.handle("POST", "/v1/healthcheck/create", json.dumps(body).encode()).status]
codes += [g.handle("GET", path).status for path in ("/healthz", "/debug/state", "/metrics")]
kube = InMemoryKube()
kube.add_namespace("prod")
plane = WatchPlane(kube, clock=lambda: 1000.0, sleep=lambda s: None)
plane.step()
streaming = WatchPlane(HttpKube(base_url="http://127.0.0.1:9"), stream=True).stream
try:
    main(["watch-plane", "--api-server", "http://127.0.0.1:9", "--gauge-port", "9100"])
    refused = ""
except SystemExit as e:
    refused = str(e)
print(json.dumps([codes, streaming, "prometheus_client" in refused]))
"""


def test_gateway_and_watch_plane_run_without_prometheus_client():
    """On a host without prometheus_client the gateway answers (its
    request counter counts nothing and /metrics answers 501), both watch
    planes are built and step, and `watch-plane --gauge-port` is refused
    by name, as `worker`'s is."""
    out = subprocess.run(
        [sys.executable, "-I", "-c", _NO_PROMETHEUS_CLIENT.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[200, 200, 200, 501], True, True]


_DASHBOARD_WITHOUT_EXTRAS = """
import json, sys
sys.path.insert(0, {root!r})
for name in ("prometheus_client", "aiohttp", "yaml", "requests"):
    sys.modules[name] = None  # `import <name>` raises ImportError
import foremast_tpu_torch.demo, foremast_tpu_torch.instrument
from foremast_tpu_torch.metrics.rules import prometheus_rule_manifest, rule_expr, to_yaml
from foremast_tpu_torch.ui.app import make_app
from foremast_tpu_torch.ui.join import join_anomalies

ui = make_app(demo=True)
codes = [ui.handle("GET", p).status for p in ("/", "/config", "/healthz", "/static/app.js",
                                             "/api/v1/panel?i=0&end=7200")]
ui.close()
yaml_text = to_yaml(prometheus_rule_manifest())
try:
    foremast_tpu_torch.instrument.HttpMetrics()
    starter = "built"
except ImportError as e:
    starter = "prometheus_client" in str(e)
print(json.dumps([codes, yaml_text.startswith("apiVersion:"),
                  rule_expr("namespace_app:pod_count") is not None,
                  join_anomalies([(1.0, 2.0)], [(1.0, 3.0)], 0.0, 0.5), starter, "torch" in sys.modules]))
"""


def test_dashboard_rules_demo_and_starter_import_without_optional_packages():
    """`ui`, `demo`, `instrument` and `metrics.rules` import on a host
    without prometheus_client, aiohttp, yaml or requests: the dashboard
    answers (demo mode), the rules render their YAML, and only building
    the starter's registry asks for prometheus_client. None of them
    imports torch."""
    out = subprocess.run(
        [sys.executable, "-I", "-c", _DASHBOARD_WITHOUT_EXTRAS.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[200] * 5, True, True, [[1.0, 2.0]], True, False]
