"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``, nor
``msgpack`` or ``ml_dtypes`` (the JAX package's snapshot codec needs them;
the machine with the card has neither)."""

import ast
from pathlib import Path

import pytest

from _torch_port import pin_threads

pin_threads()

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_sees_the_whole_port():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "moe.py", "ops.py", "scheduler_torch.py", "chip_smoke.py", "codec.py",
            "snapshot.py", "probes.py", "health.py", "timing_feed.py"} <= names
