"""No module of the benchmark or of the port imports JAX or the JAX package,
compared by whole top-level name (``jrc_tpu_torch`` begins with
``jrc_tpu``); the yardstick imports nothing of the port."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "jrc_tpu"}
#: the benchmark's modules that may drive the port: the drivers and the harness's entry
DRIVES_PORT = {"drivers", "tests"}


def imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports, at any depth."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


FILES = sorted((ROOT / "jrc_bench").rglob("*.py")) + sorted((ROOT / "jrc_tpu_torch").rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


def test_names_compared_whole():
    assert "jrc_tpu_torch" not in FORBIDDEN and "jrc_tpu" in FORBIDDEN


@pytest.mark.parametrize("path", [p for p in sorted((ROOT / "jrc_bench").rglob("*.py"))
                                  if p.relative_to(ROOT / "jrc_bench").parts[0] not in DRIVES_PORT],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_yardstick_imports_nothing_of_the_port(path):
    assert "jrc_tpu_torch" not in imported(path)
