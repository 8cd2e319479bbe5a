"""Rules of the port: it imports neither ``jax`` nor ``repro``, it runs on
the card unless asked for the CPU, and ``chip_smoke.py`` drives the store
phase end to end (rehearsed here on the CPU at a scaled-down size)."""

import ast
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import offload
from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.lsm.db import LsmDB
from repro_torch.lsm.engine import TorchCompactionEngine

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == "__import__" and \
                node.args and isinstance(node.args[0], ast.Constant):
            mods.add(node.args[0].value)
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_scan_sees_the_whole_port():
    names = {p.name for p in PORT_FILES}
    assert {"db.py", "engine.py", "compaction.py", "ops.py", "ref.py",
            "chip_smoke.py"} <= names


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("make", [
    lambda tmp: LsmDB(str(tmp / "db")),
    lambda tmp: TorchCompactionEngine(SSTGeometry()),
    lambda tmp: offload.CompactionExecutor(SSTGeometry()),
    lambda tmp: resolve_device(None),
    lambda tmp: resolve_device("cuda"),
], ids=["LsmDB", "engine", "executor", "default", "cuda"])
def test_entry_points_refuse_to_run_without_the_card(make, tmp_path,
                                                     no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(tmp_path)
    assert not (tmp_path / "db").exists()


def test_cpu_runs_only_when_asked(tmp_path, no_cuda):
    assert resolve_device("cpu").type == "cpu"
    db = LsmDB(str(tmp_path / "db"), device="cpu")
    assert db.device.type == "cpu"
    db.close()
    with pytest.raises(ValueError):
        resolve_device("meta")


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_store_phase_rehearsal(tmp_path):
    """Phase 3 and 4 on the CPU at 1/64 of the paper scale, with the same
    ratios of records to SST size and L1 quota: the run must show the
    compactions the card run asserts, and the kept job must compare."""
    cs = _chip_smoke()
    div = 64
    geom = SSTGeometry(key_bytes=16, value_bytes=272, block_bytes=4096,
                       sst_bytes=4 * 1024 * 1024 // div)
    sched = SchedulerConfig(l0_trigger=4, base_bytes=32 * 1024 * 1024 // div)
    before = ops.launch_counts()
    st = cs.run_store(str(tmp_path / "db"), device="cpu", geom=geom,
                      sched=sched, records=330_000 // div,
                      operations=20_000 // div, deletes=2_000 // div,
                      value_size=256, batch=16, sample=300, scan_keys=80,
                      keep_dir=str(tmp_path / "job"))
    assert st["l0_jobs"] >= 4 and st["l0_min_inputs"] >= 4
    assert st["l1_jobs"] >= 1
    assert st["launches"] == before   # CPU tensors launch no kernel
    assert cs.compare_job(st["kept"], geom, "cpu") > 0


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _run(["chip_smoke.py"], REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
