"""The port stands alone: no module of `foremast_tpu_torch` and no line of
`chip_smoke.py` imports JAX, the JAX package or scipy (the one host
constant the JAX package takes from scipy is `torch.special.ndtri` here),
and no module of the port imports `requests` or `prometheus_client` when
it is imported (the card's machine has neither).

The import check runs in a fresh interpreter (`-I`: no site hooks, no
PYTHONPATH), because this test process has JAX loaded already."""

import ast
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
for name in names:
    importlib.import_module(name)
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "foremast_tpu", "scipy", "requests", "prometheus_client")
)
print(len(names), bad)
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-I", "-c", _IMPORT_ALL.format(root=str(ROOT))],
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
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 34
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "foremast_tpu", "scipy"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
