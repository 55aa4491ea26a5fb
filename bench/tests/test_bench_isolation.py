"""Nothing under bench/ imports JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's),
and nothing there reads the JAX package's benchmarks/."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_module_under_bench_imports_jax_or_the_jax_package():
    found = {}
    for path in sorted(BENCH.rglob("*.py")):
        for name in _imports(path):
            if name and name.split(".")[0] in FORBIDDEN:
                found.setdefault(str(path.relative_to(BENCH)), []).append(name)
    assert found == {}


def test_the_scan_tells_the_port_from_the_jax_package(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.fl\nfrom repro.fl import job\n"
                 "import importlib\nimportlib.import_module('jax.numpy')\n")
    names = [n.split(".")[0] for n in _imports(f)]
    assert [n for n in names if n in FORBIDDEN] == ["repro", "jax"]
