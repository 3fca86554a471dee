"""The port's deploy-manifest generator (`foremast_tpu_torch/deploy/`)
against the JAX package's (`foremast_tpu/deploy/`).

The port's `tree()` is JAX's, key for key and value for value, once the
port's departures are applied to JAX's tree, each by name:

  image        `foremast/foremast-tpu:0.1.0` -> `foremast/foremast-tpu-torch:0.1.0`
  command      the containers' `foremast` -> `foremast-tpu-torch` (the
               port's console script), and the demo's
               `python -m foremast_tpu.demo` -> `python -m foremast_tpu_torch.demo`
  no_sharded   the engine runs `worker` without `--sharded`
  gpu          the engine requests `nvidia.com/gpu: 1` (limits and
               requests) instead of `google.com/tpu: 8`, with the GKE
               node selector `cloud.google.com/gke-accelerator:
               nvidia-h100-80gb` instead of the v5e 2x4 one
  readme       the README speaks of the card

Every file renders byte for byte as JAX's `render_file` renders the same
content, `deploy_torch/` is current, and the counterparts of
`tests/test_deploy.py`'s cases hold for the port's tree."""

from __future__ import annotations

import copy
import json
import os

import pytest
import yaml

import foremast_tpu.deploy.manifests as J
import foremast_tpu_torch.deploy.manifests as P
from foremast_tpu_torch.config import _DEFAULT_RULES, BrainConfig
from foremast_tpu_torch.watch.crds import GROUP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = "foremast/3_engine/foremast-engine.yaml"


def _walk(node, fn):
    """Apply fn to every dict of a manifest tree, depth first; the sum of
    its return values (how many places it changed)."""
    n = 0
    if isinstance(node, dict):
        n += fn(node)
        for v in node.values():
            n += _walk(v, fn)
    elif isinstance(node, list):
        for v in node:
            n += _walk(v, fn)
    return n


def _image(d):
    if d.get("image") == J.IMAGE:
        d["image"] = P.IMAGE
        return 1
    return 0


def _command(d):
    if d.get("command") == ["foremast"]:
        d["command"] = ["foremast-tpu-torch"]
        return 1
    if d.get("command") == ["python", "-m", "foremast_tpu.demo"]:
        d["command"] = ["python", "-m", "foremast_tpu_torch.demo"]
        return 1
    return 0


def _engine_container(docs) -> dict:
    dep = next(d for d in docs if d["kind"] == "Deployment")
    return dep["spec"]["template"]["spec"]["containers"][0]


def _no_sharded(t) -> int:
    c = _engine_container(t[ENGINE])
    n = c["args"].count("--sharded")
    c["args"] = [a for a in c["args"] if a != "--sharded"]
    return n


def _gpu(t) -> int:
    c = _engine_container(t[ENGINE])
    for side in ("limits", "requests"):
        assert c["resources"][side].pop("google.com/tpu") == 8
        c["resources"][side]["nvidia.com/gpu"] = 1
    dep = next(d for d in t[ENGINE] if d["kind"] == "Deployment")
    dep["spec"]["template"]["spec"]["nodeSelector"] = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    return 1


def _readme(t) -> int:
    t["README.md"] = P.README
    return 1


DEPARTURES = {
    "image": lambda t: _walk(t, _image),
    "command": lambda t: _walk(t, _command),
    "no_sharded": _no_sharded,
    "gpu": _gpu,
    "readme": _readme,
}


def _jax_tree_with_departures() -> dict:
    t = copy.deepcopy(J.tree())
    for name, apply in DEPARTURES.items():
        assert apply(t) >= 1, f"departure {name} changed nothing"
    return t


def test_tree_equals_jax_once_departures_are_applied():
    want = _jax_tree_with_departures()
    got = P.tree()
    assert list(got) == list(want)
    for rel in want:
        assert got[rel] == want[rel], rel


@pytest.mark.parametrize("name", sorted(DEPARTURES))
def test_each_departure_is_needed(name):
    """Leaving any one departure out makes the trees differ: none of them
    is vacuous."""
    t = copy.deepcopy(J.tree())
    for other, apply in DEPARTURES.items():
        if other != name:
            apply(t)
    assert t != P.tree()


def test_render_file_is_byte_equal_to_jax():
    for rel, content in P.tree().items():
        assert P.render_file(content) == J.render_file(content), rel


def test_committed_deploy_torch_is_current():
    """deploy_torch/ matches the generator (`python -m
    foremast_tpu_torch.deploy deploy_torch/` after editing manifests.py),
    and holds no file the generator does not write."""
    root = os.path.join(REPO, "deploy_torch")
    t = P.tree()
    for rel, content in t.items():
        path = os.path.join(root, rel)
        assert os.path.exists(path), f"missing {rel}"
        with open(path) as f:
            assert f.read() == P.render_file(content), f"stale {rel}"
    on_disk = {
        os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
        for d, _, files in os.walk(root) for f in files
    }
    assert on_disk == set(t)


def test_render_writes_the_tree(tmp_path):
    written = P.render(str(tmp_path))
    assert len(written) == len(P.tree())
    sh = tmp_path / "minikube.sh"
    assert os.access(sh, os.X_OK)


def test_engine_requests_one_card_and_nothing_of_the_tpu():
    c = _engine_container(P.tree()[ENGINE])
    assert c["resources"]["limits"]["nvidia.com/gpu"] == 1
    assert c["resources"]["requests"]["nvidia.com/gpu"] == 1
    assert "--sharded" not in c["args"] and c["args"][0] == "worker"
    for rel, content in P.tree().items():
        text = P.render_file(content)
        assert "google.com/tpu" not in text and "gke-tpu" not in text, rel
        assert "foremast_tpu." not in text and "foremast_tpu/" not in text.replace("foremast_tpu_torch/", ""), rel


def test_engine_env_matrix_roundtrips_through_brainconfig():
    """The engine Deployment's env block reproduces BrainConfig when
    parsed by the port's BrainConfig.from_env: the no-drift guarantee."""
    env = {
        e["name"]: e["value"]
        for e in _engine_container(P.tree()[ENGINE])["env"]
        if "value" in e
    }
    cfg = BrainConfig.from_env(env)
    assert cfg == BrainConfig()
    assert cfg.algorithm == "moving_average_all"
    assert cfg.anomaly.rules == _DEFAULT_RULES
    assert cfg.pairwise.min_mann_white_points == 20
    assert cfg.max_stuck_seconds == 90.0


def test_crds_match_runtime_types():
    t = P.tree()
    for rel, plural, kind in [
        ("foremast/1_crds/deploymentmetadata.yaml", "deploymentmetadatas", "DeploymentMetadata"),
        ("foremast/1_crds/deploymentmonitor.yaml", "deploymentmonitors", "DeploymentMonitor"),
    ]:
        (crd,) = t[rel]
        assert crd["metadata"]["name"] == f"{plural}.{GROUP}"
        assert crd["spec"]["names"]["kind"] == kind
        assert crd["spec"]["versions"][0]["name"] == "v1alpha1"


def test_monitor_crd_enums():
    (crd,) = P.tree()["foremast/1_crds/deploymentmonitor.yaml"]
    props = crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]["properties"]
    phases = props["status"]["properties"]["phase"]["enum"]
    assert {"Healthy", "Running", "Unhealthy", "Expired", "Abort"} <= set(phases)
    opts = props["spec"]["properties"]["remediation"]["properties"]["option"]["enum"]
    assert opts == ["None", "AutoRollback", "AutoPause", "Auto"]


def test_rendered_yaml_parses_and_has_no_aliases():
    for rel, content in P.tree().items():
        text = P.render_file(content)
        if rel.endswith((".yaml", ".yml")):
            docs = list(yaml.safe_load_all(text))
            assert docs, rel
            assert "&id" not in text, f"yaml anchors leaked into {rel}"


def test_rbac_covers_rollback_and_crds():
    docs = P.tree()["foremast/2_watch/foremast-watch-rbac.yaml"]
    role = next(d for d in docs if d["kind"] == "ClusterRole")
    resources = {r for rule in role["rules"] for r in rule["resources"]}
    assert {"deployments", "deployments/rollback", "replicasets", "pods",
            "deploymentmonitors", "deploymentmetadatas"} <= resources


def test_monitoring_stack_is_self_contained():
    """Prometheus (scrape job + the port's recording rules as native rule
    files), kube-state-metrics, and Grafana wired to prometheus-k8s, its
    dashboard generated from the port's own panel spec."""
    from foremast_tpu_torch.ui.metrics import DEFAULT_PANELS

    t = P.tree()
    data = t["prometheus/2_stack/prometheus-config.yaml"][0]["data"]
    prom_cfg = yaml.safe_load(data["prometheus.yml"])
    assert {j["job_name"] for j in prom_cfg["scrape_configs"]} == {"kube-state-metrics", "kubernetes-pods-scrape"}
    assert prom_cfg["rule_files"] == ["/etc/prometheus/rules.yml"]
    rules = yaml.safe_load(data["rules.yml"])
    records = [r["record"] for g in rules["groups"] for r in g["rules"] if "record" in r]
    assert "namespace_pod:http_server_requests_error_5xx" in records
    assert any(r.startswith("foremastbrain:") for r in records)
    assert any(r.get("alert") == "ForemastEngineDown" for g in rules["groups"] for r in g["rules"])
    svc = next(d for d in t["prometheus/2_stack/prometheus.yaml"] if d["kind"] == "Service")
    assert svc["metadata"]["name"] == "prometheus-k8s" and svc["spec"]["ports"][0]["port"] == 9090
    ksm = t["prometheus/2_stack/kube-state-metrics.yaml"]
    assert {d["kind"] for d in ksm} == {"ServiceAccount", "ClusterRole", "ClusterRoleBinding", "Deployment",
                                        "Service"}
    graf = t["prometheus/2_stack/grafana.yaml"]
    cms = {d["metadata"]["name"]: d for d in graf if d["kind"] == "ConfigMap"}
    assert "prometheus-k8s.monitoring.svc:9090" in cms["grafana-datasources"]["data"]["datasources.yaml"]
    dash = json.loads(cms["grafana-dashboard-foremast"]["data"]["foremast.json"])
    assert len(dash["panels"]) == len(DEFAULT_PANELS)
    for p, spec in zip(dash["panels"], DEFAULT_PANELS):
        exprs = [tgt["expr"] for tgt in p["targets"]]
        assert len(exprs) == 4 and any(spec.metric in e for e in exprs)
        assert all("$namespace" in e and "$app" in e for e in exprs)


def test_alertmanager_and_node_exporter_complete_the_stack():
    t = P.tree()
    am = t["prometheus/2_stack/alertmanager.yaml"]
    assert [d["kind"] for d in am] == ["ConfigMap", "Deployment", "Service"]
    am_cfg = yaml.safe_load(next(d for d in am if d["kind"] == "ConfigMap")["data"]["alertmanager.yml"])
    assert am_cfg["route"]["receiver"] in {r["name"] for r in am_cfg["receivers"]}
    prom_cfg = yaml.safe_load(t["prometheus/2_stack/prometheus-config.yaml"][0]["data"]["prometheus.yml"])
    targets = prom_cfg["alerting"]["alertmanagers"][0]["static_configs"][0]["targets"]
    assert targets == ["alertmanager-main.monitoring.svc:9093"]
    ds = next(d for d in t["prometheus/2_stack/node-exporter.yaml"] if d["kind"] == "DaemonSet")
    assert ds["spec"]["template"]["metadata"]["annotations"]["prometheus.io/scrape"] == "true"


def test_readme_speaks_of_the_card():
    assert "python -m foremast_tpu_torch.deploy deploy_torch/" in P.README
    assert "nvidia.com/gpu: 1" in P.README and "H100" in P.README
    assert "TPU" not in P.README
