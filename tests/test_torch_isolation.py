"""The port imports nothing of JAX and nothing of the JAX package.

Every ``.py`` file under ``src/repro_torch/``, ``chip_smoke.py``,
``scripts/http_smoke_torch.py`` and ``examples/*_torch.py`` is parsed
with ``ast``; no import in it, at module level or inside a function,
names ``jax``, ``jaxlib`` or ``repro`` (``repro_torch`` is the port).
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted([*(ROOT / "src" / "repro_torch").rglob("*.py"),
                ROOT / "chip_smoke.py",
                ROOT / "scripts" / "http_smoke_torch.py",
                *(ROOT / "examples").glob("*_torch.py")])
FORBIDDEN = {"jax", "jaxlib", "repro"}


def imported_roots(tree):
    """(line, top-level package) of every import in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value.split(".")[0]


def test_the_file_list_covers_the_port():
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "http_smoke_torch.py", "quickstart_torch.py",
            "train_moe_torch.py", "model.py", "ops.py", "collectives.py",
            "sharding.py", "mesh.py"} <= names
    paths = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"src/repro_torch/distributed/collectives.py",
            "src/repro_torch/distributed/sharding.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/specs.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/launch/dryrun_all.py",
            "src/repro_torch/hardware.py"} <= paths
    assert len(FILES) > 60


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in imported_roots(tree)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
