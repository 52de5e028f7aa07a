"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``, nor
``msgpack`` or ``ml_dtypes`` (the JAX package's snapshot codec needs them;
the machine with the card has neither)."""

import ast
import os
import subprocess
import sys
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
            "snapshot.py", "probes.py", "health.py", "timing_feed.py", "plan.py", "inject.py",
            "chaos.py", "journal.py", "scheduler.py", "cost_model.py", "mesh.py", "sharding.py",
            "collectives.py", "ssm.py", "zamba2_7b.py", "rwkv6_7b.py", "whisper_base.py",
            "optimizer.py", "compression.py", "train_loop.py", "checkpoint.py", "fault_tolerance.py",
            "tree.py", "pipeline.py", "train.py"} <= names


def test_fault_and_recovery_modules_import_with_jax_blocked():
    """The fault plan, injector, chaos harness and recovery journal, the
    mesh, sharding and collectives modules of expert parallelism, and the
    SSM blocks and the hybrid, ssm and audio configs, import (and the chaos
    harness's CPU entry point resolves, and those three models build) in
    a process where importing JAX or the JAX package fails."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in %r:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.faults.plan, repro_torch.faults.inject\n"
        "import repro_torch.faults.chaos, repro_torch.recovery.journal\n"
        "from repro_torch.faults import EngineChaos, make_plan, run_engine_chaos\n"
        "from repro_torch.recovery import RecoveryJournal\n"
        "from repro_torch.launch.mesh import make_mesh, mesh_info_for, run_on_mesh\n"
        "from repro_torch.models.sharding import rank_cut\n"
        "from repro_torch.models.collectives import all_to_all\n"
        "from repro_torch.models.ssm import mamba2_seq, rwkv6_block_seq\n"
        "from repro_torch.configs import get_arch\n"
        "from repro_torch.models import LM\n"
        "for name in ('zamba2-7b', 'rwkv6-7b', 'whisper-base'):\n"
        "    LM(get_arch(name).reduced(), device='cpu').init(seed=0)\n"
    ) % (FORBIDDEN,)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr


def test_training_modules_import_and_step_with_jax_blocked(tmp_path):
    """The training modules, the data pipeline and the launcher import,
    and one launcher step on the CPU runs, in a process where importing
    JAX or the JAX package fails."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in %r:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.train, repro_torch.train.compression, repro_torch.data.pipeline\n"
        "from repro_torch.launch.train import main\n"
        "main(['--arch', 'qwen1.5-0.5b', '--device', 'cpu', '--steps', '1', '--seq-len', '8',\n"
        "      '--global-batch', '2', '--ckpt-dir', %r])\n"
    ) % (FORBIDDEN, str(tmp_path))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
