"""The port stands alone: ``repro_torch``, the ``examples/*_torch.py`` and
``chip_smoke.py`` import nothing of JAX and nothing of the JAX package
``repro``, importing the port starts no process group, and the entry
points place state on the card unless the caller names another device.
Every test process runs one torch thread (the root ``conftest.py``)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.core as T

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


def test_no_source_file_imports_jax_or_the_jax_package():
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(examples) == 4
    files = sorted(PORT.rglob("*.py")) + examples + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    names = {str(f.relative_to(PORT)) for f in files
             if f.is_relative_to(PORT)}
    assert {"runtime/wal.py", "runtime/recovery.py",
            "checkpoint/checkpointer.py", "testing/schedules.py",
            "launch/durable_serve.py", "core/partition.py",
            "core/distributed.py", "parallel/sharding.py",
            "parallel/collectives.py", "configs/base.py",
            "configs/qwen2_1_5b.py", "models/layers.py",
            "models/attention.py", "models/transformer.py",
            "models/model.py", "launch/serve.py", "models/moe.py",
            "models/ssm.py", "models/rglru.py", "models/encdec.py",
            "data/tokenizer.py", "data/pathgen.py", "data/pipeline.py",
            "optim/adamw.py", "optim/grad_compress.py", "optim/schedule.py",
            "launch/steps.py", "launch/train.py",
            "runtime/train_loop.py", "launch/mesh.py", "launch/dryrun.py",
            "testing/proptest.py"} <= names
    for f in files:
        bad = _imported_roots(f) & set(FORBIDDEN)
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax_module():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.convert\n"
        "import repro_torch.kernels.bfs_multi_step.ops\n"
        "import repro_torch.kernels.bfs_pull_step.ops\n"
        "import repro_torch.kernels.bfs_step.ops\n"
        "import repro_torch.kernels.edge_update.ops\n"
        "import repro_torch.kernels.label_join.ops\n"
        "import repro_torch.index\n"
        "import repro_torch.kernels._build\n"
        "import repro_torch.checkpoint, repro_torch.runtime.wal\n"
        "import repro_torch.runtime.recovery\n"
        "import repro_torch.testing.schedules\n"
        "import repro_torch.launch.durable_serve\n"
        "import repro_torch.core.partition, repro_torch.core.distributed\n"
        "import repro_torch.parallel.sharding\n"
        "import repro_torch.parallel.collectives\n"
        "import repro_torch.configs, repro_torch.models.model\n"
        "import repro_torch.models.moe, repro_torch.models.ssm\n"
        "import repro_torch.models.rglru, repro_torch.models.encdec\n"
        "import repro_torch.runtime.serve_loop, repro_torch.launch.serve\n"
        "import repro_torch.data, repro_torch.optim\n"
        "import repro_torch.launch.steps, repro_torch.launch.train\n"
        "import repro_torch.runtime.train_loop\n"
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
        "import repro_torch.testing.proptest\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "from repro_torch.configs import ARCHS, get_config\n"
        "[get_config(a) for a in ARCHS]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert T.make_graph(64).vkey.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.make_graph(64)
    with pytest.raises(RuntimeError):
        T.make_op_batch([(T.OP_ADD_V, 1)])
    assert T.make_graph(64, device="cpu").vkey.device.type == "cpu"


def test_each_test_process_runs_one_torch_thread():
    """Six workers at torch's default of a thread a core oversubscribe the
    cores, and the CPU tests' small ops spin against each other."""
    assert torch.get_num_threads() == 1
