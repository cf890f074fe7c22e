"""The port stands alone: no module of librabft_simulator_tpu_torch, and not
chip_smoke.py, imports jax (or flax) or anything of the JAX package."""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "librabft_simulator_tpu")


def _port_files():
    files = sorted((ROOT / "librabft_simulator_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    names = {str(p.relative_to(ROOT)) for p in files}
    for mod in ("serve/service.py", "serve/api.py", "serve/cli.py", "distributed/egress.py"):
        assert f"librabft_simulator_tpu_torch/{mod}" in names, mod
    bad = []
    for path in files:
        for mod in _imported(ast.parse(path.read_text(), str(path))):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad
