"""Rules of the port: it imports neither ``jax`` nor ``repro``, it runs on
the card unless asked for the CPU, and ``chip_smoke.py`` drives the store
phase end to end (rehearsed here on the CPU at a scaled-down size)."""

import ast
import contextlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import offload
from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.data.ycsb import WorkloadSpec
from repro_torch.lsm.db import DBConfig, LsmDB
from repro_torch.lsm.sharded import ShardedDB
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import dryrun, serve, train, ycsb
from repro_torch.lsm.engine import TorchCompactionEngine
from repro_torch.models import model
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.session_store import MemorySessionStore
from repro_torch.testing import crashmatrix
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.training import train_step
from repro_torch.training.train_loop import Trainer, TrainLoopConfig

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
            "sharded.py", "background.py", "chip_smoke.py"} <= names
    # the roofline and the dry run (ROADMAP A16)
    rel = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {f"src/repro_torch/roofline/{m}.py" for m in (
        "constants", "counts", "memory", "analysis")} | {
        "src/repro_torch/launch/dryrun.py"} <= rel


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("make", [
    lambda tmp: LsmDB(str(tmp / "db")),
    lambda tmp: TorchCompactionEngine(SSTGeometry()),
    lambda tmp: offload.CompactionExecutor(SSTGeometry()),
    lambda tmp: resolve_device(None),
    lambda tmp: resolve_device("cuda"),
    lambda tmp: model.init(0, get_smoke_config("falcon-mamba-7b")),
    lambda tmp: model.init_cache(get_smoke_config("falcon-mamba-7b"), 1, 8),
    lambda tmp: ServeEngine(get_smoke_config("falcon-mamba-7b"), {}),
    lambda tmp: serve.main(["--arch", "falcon-mamba-7b", "--smoke"]),
    lambda tmp: LsmDB(str(tmp / "db"), DBConfig(engine="cpu")),
    lambda tmp: ycsb.run(WorkloadSpec(records=20, operations=20),
                         DBConfig(engine="cpu"), path=str(tmp / "db")),
    lambda tmp: ycsb.main(["--records", "20", "--engine", "cpu"]),
    lambda tmp: MemorySessionStore(lambda: None),
    lambda tmp: ServeEngine(get_smoke_config("falcon-mamba-7b"), {},
                            page_store=object()),
    lambda tmp: ShardedDB(str(tmp / "db")),
    lambda tmp: ShardedDB(str(tmp / "db"), DBConfig(engine="cpu"),
                          shards=2),
    lambda tmp: LsmDB.open(str(tmp / "db"), repair=True),
    lambda tmp: ShardedDB.open(str(tmp / "db"), repair=True),
    lambda tmp: crashmatrix.run_cell("wal.append", "sync",
                                     workdir=str(tmp / "db")),
    lambda tmp: train_step.init_state(0, get_smoke_config("falcon-mamba-7b")),
    lambda tmp: CheckpointStore(str(tmp / "db")),
    lambda tmp: Trainer(get_smoke_config("falcon-mamba-7b"),
                        TrainLoopConfig(steps=1), str(tmp / "db")),
    lambda tmp: train.main(["--arch", "falcon-mamba-7b", "--smoke",
                            "--steps", "1", "--ckpt", str(tmp / "db")]),
    lambda tmp: launch_mesh.make_host_mesh(),
    lambda tmp: launch_mesh.make_production_mesh(),
    lambda tmp: launch_mesh.build_mesh((1,), ("data",)),
    lambda tmp: train.main(["--arch", "falcon-mamba-7b", "--smoke",
                            "--steps", "1", "--ckpt", str(tmp / "db"),
                            "--mesh-shape", "1", "1"]),
    lambda tmp: dryrun.main(["--arch", "falcon-mamba-7b", "--shape",
                             "decode_32k", "--out", str(tmp / "db")]),
], ids=["LsmDB", "engine", "executor", "default", "cuda", "model.init",
        "model.init_cache", "ServeEngine", "launch.serve", "LsmDB-cpu-engine",
        "ycsb.run", "launch.ycsb", "MemorySessionStore",
        "ServeEngine-page_store", "ShardedDB", "ShardedDB-cpu-engine",
        "LsmDB.open-repair", "ShardedDB.open-repair",
        "crashmatrix.run_cell", "train_step.init_state", "CheckpointStore",
        "Trainer", "launch.train", "make_host_mesh", "make_production_mesh",
        "build_mesh", "launch.train-mesh", "launch.dryrun"])
def test_entry_points_refuse_to_run_without_the_card(make, tmp_path,
                                                     no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(tmp_path)
    assert not (tmp_path / "db").exists()


def test_table_reader_multi_get_runs_on_the_card_unless_asked(tmp_path):
    db = LsmDB(str(tmp_path / "db"), device="cpu")
    db.put(b"k1", b"v1")
    db.flush()
    fm = db.versions.current.levels[0][0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        from repro_torch.lsm import ReadOptions, sstable
        rdr = sstable.TableReader(fm, db.geom)         # no device: cuda
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rdr.multi_get([b"k1"])
        assert rdr.multi_get([b"k1"], ReadOptions(backend="host")) == [b"v1"]
        assert db.cache.reader(fm).multi_get([b"k1"]) == [b"v1"]   # cpu
    db.close()


def test_cpu_runs_only_when_asked(tmp_path, no_cuda, capsys):
    assert resolve_device("cpu").type == "cpu"
    db = LsmDB(str(tmp_path / "db"), device="cpu")
    assert db.device.type == "cpu"
    db.close()
    with pytest.raises(ValueError):
        resolve_device("meta")
    for engine in ("device", "cpu"):
        ycsb.main(["--records", "300", "--operations", "200", "--engine",
                   engine, "--value-size", "64", "--device", "cpu"])
        r = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert (r["engine"], r["device"], r["records"]) == (engine, "cpu",
                                                            300)
        assert r["compact_device_s"] is None   # no device time on the CPU
        assert r["reads_checked"] > 50 and r["scan_rows"] == 300


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
    compactions the card run asserts, every ``multi_get`` batch must agree
    before and after the reopen (the bloom prune running on the cold
    cache), and the kept job must compare across devices and with
    ``sort_mode="device"``."""
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
                      mg_batches=4, keep_dir=str(tmp_path / "job"))
    assert st["l0_jobs"] >= 4 and st["l0_min_inputs"] >= 4
    assert st["l1_jobs"] >= 1
    assert st["launches"] == before   # CPU tensors launch no kernel
    for when in ("warm", "cold"):
        mg = st["multi_get"][when]
        assert len(mg["lat_us"]) == 5 and mg["waves"] >= 6
        assert mg["staged_bytes"] > 0
    assert st["multi_get"]["cold"]["pruned"] > 0
    assert "keys/s" in cs.multi_get_line("cold", st["multi_get"]["cold"])
    live, launches = cs.compare_job(st["kept"], geom, "cpu")
    assert live > 0 and launches == before


def test_chip_smoke_paper_phase_rehearsal(tmp_path):
    """Phase 6 on the CPU at 1/64 of the paper's SST and L1 sizes (the
    records scale with them): both stores on ``device="cpu"``, every read
    and a full scan checked by ``ycsb.run``, the same SST files, no kernel
    launched (CPU tensors launch none, and the baseline none anywhere);
    a row per store and value size and a ratio line per value size."""
    cs = _chip_smoke()
    div = 64

    def geometry(v):
        return SSTGeometry(key_bytes=16, value_bytes=v + 16,
                           block_bytes=4096, sst_bytes=4 * 1024 * 1024 // div,
                           bloom_bits_per_key=10)

    sched = SchedulerConfig(l0_trigger=4, base_bytes=32 * 1024 * 1024 // div)
    rows = cs.paper_phase(str(tmp_path), "cpu", geometry=geometry,
                          sched=sched)
    assert [(r["value_size"], r["store"]) for r in rows] == [
        (v, s) for v in (128, 256, 512, 1024) for s in ("LUDA", "baseline")]
    assert [r["records"] for r in rows[::2]] == [
        10 * (65_536 // (16 + v)) for v in (128, 256, 512, 1024)]
    for r in rows:
        assert not any(r["launches"].values())
        assert r["l0_jobs"] >= 2 and r["l0_min_inputs"] >= 4
        assert r["reads_checked"] > 0 and r["scan_rows"] == r["records"]
        assert r["compact_device_s"] is None
        line = cs.paper_row_line(r, "card", "host")
        assert "ops/s" in line and "MB/s over" in line and \
            "[card; host host]" in line
    for luda, base in zip(rows[::2], rows[1::2]):
        assert luda["compact_bytes_in"] == base["compact_bytes_in"] > 0
        assert "LUDA / baseline: run ops/s" in cs.paper_ratio_line(
            luda, base, "card", "host")
    assert os.listdir(tmp_path) == []
    assert "CPUs" in cs.host_line()
    assert cs.paper_records(cs.PAPER_GEOM, 128) == 291_270
    assert [cs.paper_records(cs.PAPER.geometry(v), v)
            for v in cs.PAPER.value_sizes] == [291_270, 154_200, 79_430,
                                               40_320]


def test_chip_smoke_job_baseline_rehearsal(tmp_path):
    """Phase 4's comparison of the kept job holds the numpy baseline too:
    its trimmed image equals the engine's, and one flipped bit in it
    fails the run."""
    import numpy as np
    from unittest import mock
    from repro_torch.lsm import sstable
    from repro_torch.lsm.cpu_engine import CpuCompactionEngine
    cs = _chip_smoke()
    geom = SSTGeometry(key_bytes=16, value_bytes=32, block_bytes=512,
                       sst_bytes=2048)
    eng = TorchCompactionEngine(geom, device="cpu")
    rng = np.random.default_rng(0)
    paths = []
    for f in range(4):
        ids = np.sort(rng.choice(200, 40, replace=False))
        keys = np.stack([np.frombuffer(b"key%05d\x01\x01\x01\x01\x01\x01\x01\x01"
                                       % i, ">u4") for i in ids])
        meta = ((np.arange(40) + 100 * f + 1) << 1 | 1).astype(np.uint32)
        vals = rng.integers(0, 2**32, (40, geom.value_words),
                            dtype=np.uint32)
        img = sstable.trim_image(eng.build_image(keys, meta, vals))
        paths.append(str(tmp_path / f"{f:06d}.sst"))
        sstable.write_sst(paths[-1], img, f)
    kept = {"paths": paths, "bottom_level": False}
    live, launches = cs.compare_job(kept, geom, "cpu")
    assert live > 40 and not any(launches.values())

    real = CpuCompactionEngine.compact_paths

    def flipped(self, ps, *, bottom_level=False):
        out, es = real(self, ps, bottom_level=bottom_level)
        vals = out.vals.copy()
        vals[0, 0, 0] ^= 1
        return out._replace(vals=vals), es

    with mock.patch.object(CpuCompactionEngine, "compact_paths", flipped):
        with pytest.raises(AssertionError, match="numpy baseline"):
            cs.compare_job(kept, geom, "cpu")


def test_chip_smoke_pinned_copies_check():
    """Phase 4 splits the job's copies by direction and host memory, and
    fails unless both directions went through pinned staging."""
    cs = _chip_smoke()
    trace = [("Memcpy HtoD (Pinned -> Device)", 0.5),
             ("Memcpy DtoH (Device -> Pinned)", 0.75),
             ("Memcpy DtoH (Device -> Pageable)", 0.0025),
             ("Memcpy DtoH (Device -> Pinned)", 0.25), ("Memset (Device)", 1),
             ("void at::native::elementwise_kernel<...>", 1.0)]
    split = cs.memcpy_split(trace)
    assert split == {"HtoD Pinned": (1, 0.5), "DtoH Pinned": (2, 1.0),
                     "DtoH Pageable": (1, 0.0025)}
    cs.check_pinned({"memcpy": split})
    for bad in ({"HtoD Pageable": (1, 0.5), "DtoH Pinned": (1, 1.0)},
                {"HtoD Pinned": (1, 0.5), "DtoH Pinned": (1, 0.1),
                 "DtoH Pageable": (1, 1.0)}):
        with pytest.raises(AssertionError, match="pinned staging"):
            cs.check_pinned({"memcpy": bad})


def test_chip_smoke_read_kernel_cases_rehearsal():
    """Phase 2's read-path and sort cases built on the CPU at the card's
    shapes: each kernel call (here its plain version) equals the plain
    call, and the bounds count bytes and operations."""
    import numpy as np
    cs = _chip_smoke()
    cases = cs.read_kernel_cases(np.random.default_rng(2020), "cpu")
    assert [c[0] for c in cases] == [
        "bloom_multi_probe/256", "lookup_blocks/256",
        "bloom_multi_probe/1024", "lookup_blocks/1024", "bloom_query",
        "bitonic_sort/65536", "bitonic_sort/262144"]
    for name, kern, plain, nbytes, nops in cases:
        assert cs.compare_outputs(name, kern(), plain())[0] == 0
        assert nbytes > 0 and nops > 0
        if name.startswith("bitonic_sort"):
            # a sort's bound is moving the rows once, not the network
            assert nbytes / cs.HBM_BYTES_PER_S > nops / cs.SCALAR_OPS_PER_S
    # the read waves at the store's batch size: one candidate a key
    assert cases[0][1]().shape[0] == cs.MULTI_GET_BATCH
    with pytest.raises(AssertionError, match="differs"):
        cs.compare_outputs("x", torch.zeros(3, dtype=torch.int32),
                           torch.ones(3, dtype=torch.int32))
    found = cases[1][1]()[:, 0]   # the packed form: found, meta, value
    hit = cases[0][1]()
    assert 0 < int(found.sum()) < found.numel()
    assert 0 < int(hit.sum()) < hit.numel()


def test_chip_smoke_read_edge_cases_rehearsal():
    """Phase 2's read edge blocks are sorted, hold both hits and misses,
    and their packed plain lookup is the three outputs side by side; a
    call that launches no kernel (here on the CPU) fails the one-launch
    check."""
    import numpy as np
    cs = _chip_smoke()
    for k, lanes, vw in cs.EDGE_SHAPES:
        blocks = cs.edge_blocks(np.random.default_rng(k), 60, k, lanes, vw)
        keys, nvalid = blocks[0], blocks[3]
        assert {0, k} <= set(nvalid.tolist())
        for i in range(60):   # sorted, the sentinel from nvalid on
            rows = [tuple(r) for r in keys[i]]
            assert rows == sorted(rows)
            assert (keys[i, nvalid[i]:] == 0xFFFFFFFF).all()
        args = [torch.from_numpy(a.view(np.int32)) for a in blocks]
        found, meta, vals = ops.lookup_blocks(*args)
        packed = ops.lookup_blocks_packed(*args)
        assert torch.equal(packed, torch.cat(
            [found.to(torch.int32)[:, None], meta[:, None], vals], dim=1))
        if k > 1:
            assert found.any() and not found.all()
    with pytest.raises(AssertionError, match="made launches"):
        cs.one_launch("lookup_blocks", lambda: ops.lookup_blocks(*args))


def test_chip_smoke_merge_cases_rehearsal():
    """Phase 2's further merge cases built on the CPU: the plain merge is
    a sort of each case, the launches the card must show are the plan's
    levels, and the tile-edge runs sit at the kernel's tile."""
    import numpy as np
    from repro_torch.kernels import merge_path
    cs = _chip_smoke()
    cases = cs.merge_cases(np.random.default_rng(0), "cpu")
    T = merge_path.TILE_ROWS
    assert [c[0] for c in cases] == [
        "merge_runs/disjoint", "merge_runs/ragged", "merge_runs/tile-1",
        "merge_runs/tile+0", "merge_runs/tile+1"]
    assert [c[2][0] for c in cases[2:]] == [T - 1, T, T + 1]
    for name, rows, lens in cases:
        assert cs.compare_outputs(name, ops.merge_runs(rows, lens),
                                  ops.sort_tuples(rows))[0] == 0
        assert cs.merge_levels(lens) == len(merge_path.plan_levels(lens))
    ragged = cases[1][2]
    assert len(ragged) == 11 and 0 in ragged and 1 in ragged
    assert cs.merge_levels(ragged) == 4


def test_chip_smoke_prefix_and_query_cases_rehearsal(tmp_path):
    """Phase 2's prefix step on the CPU: the wire case at the pack's shape
    (65,536 rows, 61,440 surviving) and the two-line route it replaced
    equal the plain version; the bound is the bytes.  Phase 4's
    ``prefix_two_lines`` patched into a compaction gives the same image.
    The edge tables hold the counts and shapes that the card checks."""
    import numpy as np
    from unittest import mock
    from repro_torch.core import compaction, formats
    cs = _chip_smoke()
    cases, _ = cs.kernel_cases(np.random.default_rng(0), "cpu")
    by = {c[0]: c for c in cases}
    for name in ("prefix_encode", "prefix_encode/wire",
                 "prefix_encode/before"):
        _, kern, plain, nbytes, nops = by[name]
        assert cs.compare_outputs(name, kern(), plain())[0] == 0
        assert nbytes / cs.HBM_BYTES_PER_S > nops / cs.SCALAR_OPS_PER_S
    shared, wire = by["prefix_encode/wire"][1]()
    assert shared.shape == (65_536,) and not shared[cs.PREFIX_COUNT:].any()
    assert shared[:cs.PREFIX_COUNT].any() and wire.shape == (65_536, 4)
    assert cs.KERNELS["prefix_encode"][1] == "prefix_encode/wire"

    geom = SSTGeometry(key_bytes=16, value_bytes=32, block_bytes=512,
                       sst_bytes=4096)
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 6, (300, 4)).astype(np.uint32), axis=0)
    n = len(keys)
    args = (cs.as_i32(keys, "cpu"),
            torch.tensor([formats.make_meta(s, 1) for s in range(1, n + 1)],
                         dtype=torch.int64).to(torch.int32),
            cs.as_i32(rng.integers(0, 2**32, (n, geom.value_words),
                                   dtype=np.uint32), "cpu"))
    runs = []
    for patch in (False, True):
        with (mock.patch.object(ops, "prefix_encode_wire",
                                cs.prefix_two_lines) if patch
              else contextlib.nullcontext()):
            img = offload.build_image(*args, n - 5, geom=geom)   # a flush
            runs.append((img, compaction.compact(
                img, geom=geom, sort_mode="device")[0]))
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert runs[0][0].shared.any()

    for n, lanes, restart in cs.PREFIX_EDGES:
        counts = cs.prefix_edge_counts(n, restart)
        assert counts[0] == 0 and counts[-1] == n and 1 in counts
        assert n % restart == 0
    assert {r for *_, r in cs.PREFIX_EDGES} == {12, 16, 24}
    assert {lanes for _, lanes, _ in cs.PREFIX_EDGES} >= {1, 4, 5, 10}
    assert any(n == r for n, _, r in cs.PREFIX_EDGES)
    words = {w for *_, w, _ in cs.QUERY_EDGES}
    assert {8, 9, 16, 17, 5120} <= words and max(words) * 4 > 48 * 1024
    assert max(g for g, *_ in cs.QUERY_EDGES) > 65_535
    filters, qkeys = cs.query_edge_inputs(5, 300, 5, 6, "cpu")
    assert filters.shape == (5, 5) and qkeys.shape == (5, 300, 4)
    assert ops.bloom_query(filters, qkeys, n_probes=6)[:, :150].all()


def test_chip_smoke_merge_jobs_line():
    """Phase 3's merge report: a job of k input files takes ceil(log2 k')
    launches, k' = k or k + 1 (the engine's padding run); anything else,
    or no launch at all, fails the run."""
    cs = _chip_smoke()
    line = cs.merge_jobs_line([(4, 2, 0.001), (5, 3, 0.002), (2, 1, 0.0),
                               (11, 4, 0.003)], "card")
    assert "10 launches in 4 compaction jobs" in line
    assert "sort span 0.0060 s" in line and "(5, 3, 2.000)" in line
    for bad in ([(4, 4, 0.0)], [(4, 1, 0.0)], [(4, 0, 0.0)]):
        with pytest.raises(AssertionError):
            cs.merge_jobs_line(bad, "card")


def test_chip_smoke_crc_bound_is_the_bytes():
    """Phase 2's CRC case at the paper geometry: the image read once and the
    CRCs written once over the HBM rate, and one table step a byte over the
    scalar rate; the bound is the bytes (0.0058 ms)."""
    import numpy as np
    cs = _chip_smoke()
    cases, sections = cs.kernel_cases(np.random.default_rng(0), "cpu")
    name, _, _, nbytes, nops = cases[0]
    n_words = sum(s.shape[1] for s in sections)
    assert name == "crc32_sections" and n_words == 1185
    assert nbytes == 4 * 4096 * n_words + 4 * 4096
    assert nops == 4 * 4096 * n_words
    bytes_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
    assert bytes_ms > nops / cs.SCALAR_OPS_PER_S * 1e3
    assert round(bytes_ms, 4) == 0.0058


def test_chip_smoke_splits_device_time_by_kernel():
    """Phase 4's breakdown: each traced name goes to the hand-written kernel
    whose ``__global__`` function it names (the sort's tile and level
    kernels to one sort, and not the merge's level kernel to it; the bloom
    build's two routes to one build; the prefix step's wire route to
    ``prefix_encode``), copies and fills to the copies, everything else to
    PyTorch's kernels; the line gives the CRC's, the copies' and PyTorch's
    shares and PyTorch's launches."""
    cs = _chip_smoke()
    by_name = {
        "(anonymous namespace)::crc32_sections_kernel(Sections, ...)": 1.0,
        "void (anonymous namespace)::sort_tile_kernel<6>(const unsigned "
        "int *, long long, int, int, unsigned int *)": 0.5,
        "void (anonymous namespace)::sort_level_kernel<6>((anonymous "
        "namespace)::Level, int)": 0.5,
        "void (anonymous namespace)::merge_level_kernel<6>((anonymous "
        "namespace)::Level)": 0.25,
        "void (anonymous namespace)::bloom_build_warp_kernel<8>(...)": 0.125,
        "(anonymous namespace)::bloom_build_block_kernel(...)": 0.125,
        "Memcpy HtoD (Pageable -> Device)": 2.0,
        "void at::native::vectorized_elementwise_kernel<4, ...>": 0.5}
    by_name["void (anonymous namespace)::prefix_encode_kernel<4, true>("
            "(anonymous namespace)::Args)"] = 0.0625
    by_name["Memset (Device)"] = 0.0625
    split = cs.split_device_time(by_name)
    assert split == {"crc32_sections": 1.0, "bitonic_sort": 1.0,
                     "merge_runs": 0.25, "bloom_build": 0.25,
                     "prefix_encode": 0.0625, cs.COPIES: 2.0625,
                     cs.PYTORCH: 0.5}
    sources = "".join(p.read_text() for p in
                      (REPO / "src/repro_torch/kernels/csrc").glob("*.cu"))
    for fn in cs.HAND_WRITTEN:
        assert f"{fn}(" in sources
    line = cs.breakdown_line(dict(
        total_ms=5.125, split=split, pytorch_launches=7, other=sorted(
            ((ms, n) for n, ms in by_name.items()
             if cs.event_kind(n) in (cs.COPIES, cs.PYTORCH)), reverse=True)),
        "card", "device")
    assert "CRC share 19.5%" in line and "copies 40.2%" in line and \
        "PyTorch kernels 9.8% in 7 launches" in line and \
        "Memcpy HtoD" in line and "sort_mode='device'" in line


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


def test_chip_smoke_serve_phase_rehearsal():
    """Phase 5 on the CPU at falcon-mamba-7b's smoke config: the scan cases
    are built at the card's dtypes (bf16 ``u``) and counted, the serve run
    goes through ``ServeEngine.generate`` (CPU tensors launch no kernel),
    and both logit comparisons hold their limit."""
    import numpy as np
    cs = _chip_smoke()
    cases = cs.scan_cases(np.random.default_rng(0), "cpu",
                          shapes=((2, 24), (1, 40)), di=128, ds=16)
    assert [c[0] for c in cases] == ["selective_scan/2x24",
                                     "selective_scan/1x40"]
    for _name, args, nbytes, n_exp, n_ops in cases:
        assert args[0].dtype == torch.bfloat16
        y, h = ops.selective_scan(*args)
        assert torch.isfinite(y).all() and torch.isfinite(h).all()
        # bf16 u (2 bytes), fp32 dt and y (4 each) dominate the bytes
        b, s, di = args[0].shape
        assert nbytes > 10 * b * s * di and n_exp > b * s * di * 16
        assert n_ops > n_exp
    cfg = get_smoke_config("falcon-mamba-7b")
    sv = cs.serve_phase(cfg, "cpu", batch=2, prompt_len=12, max_new=3)
    assert not any(sv["launches"].values())
    assert sv["tokens"].shape == (2, 3)
    assert sv["n_params"] > cfg.param_count() and sv["card_bytes"] > 0
    # no device time and no device memory on the CPU
    assert sv["prefill_device"] is sv["allocated"] is sv["peak"] is None
    for ratio, agree in (sv["decode_gap"], sv["plain_gap"]):
        assert 0 <= ratio <= cs.LOGIT_TOL and 0 <= agree <= 1
    assert sv["plain_gap"][0] == 0.0   # on the CPU both are the plain scan
    # on the CPU the engine's decode is the eager step itself
    assert sv["captured_bitwise"] and sv["captured_logits_gap"] == 0.0
    assert sv["decode_ms"] > 0 and sv["captured_ms"] > 0
    assert sv["engine"].device.type == "cpu"
    assert tuple(sv["prompts"].shape) == (2, 12)


def test_chip_smoke_session_phase_rehearsal(tmp_path):
    """Phase 7 on the CPU at falcon-mamba-7b's smoke config and a store
    scaled to the small session (256 B values, 8 KiB SSTs, a 4 KiB
    memtable): the session pages out through a flush and compactions,
    loads back bit for bit both ways, resumes to the uninterrupted run's
    tokens, is compacted away when saved over, survives a reopen and
    drops; each compaction job and each read wave of the load is held
    against the plain versions; the synthetic state writes the same SST
    files twice (``cpu`` against ``cpu`` here)."""
    cs = _chip_smoke()
    cfg = get_smoke_config("falcon-mamba-7b")
    eng = ServeEngine(cfg, model.init(0, cfg, device="cpu"), max_len=32,
                      device="cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 12), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(0))
    small = DBConfig(geom=SSTGeometry(key_bytes=16, value_bytes=256,
                                      block_bytes=2048, sst_bytes=8192),
                     memtable_bytes=4096,
                     scheduler=SchedulerConfig(l0_trigger=4,
                                               base_bytes=32 * 1024))
    ss = cs.session_phase(eng, prompts, str(tmp_path), max_new=4, resume=3,
                          db_cfg=small)
    one = cs.state_bytes(eng._state_template())   # a batch of 1
    assert ss["bytes"] == (one - 4) * 2 + 2 * 4
    chunks = -(-ss["bytes"] // 248)   # at least: the JSON adds a few
    assert ss["records"] - 1 >= chunks
    assert ss["saved"].flushes >= 1 and ss["saved"].compactions >= 1
    assert ss["churned"].compact_entries_dropped > \
        ss["saved"].compact_entries_dropped
    assert ss["tokens"].shape == (2, 3)
    assert not any(ss["launches"].values())   # CPU tensors launch none
    assert len(ss["job_checks"]) == ss["churned"].compactions
    assert sorted({n for n, _ in ss["waves"]}) == sorted(cs.WAVE_WRAPPERS)
    f = torch.zeros((8, 5), dtype=torch.int32)
    q = torch.ones((8, 4), dtype=torch.int32)
    hit = cs.ref.bloom_multi_probe(f, q, n_probes=6)
    assert cs.check_waves([("bloom_multi_probe", (f, q), {"n_probes": 6},
                            hit)]) == [("bloom_multi_probe", (8,))]
    with pytest.raises(AssertionError, match="differs from its plain"):
        cs.check_waves([("bloom_multi_probe", (f, q), {"n_probes": 6},
                         ~hit)])
    xd = cs.cross_device_pages(str(tmp_path), "cpu", nbytes=64 * 1024,
                               db_cfg=small)
    assert xd["bytes"] == 64 * 1024
    assert xd["dev"]["stats"].compactions >= 1
    assert xd["dev"]["files"] == xd["cpu"]["files"] != {}
    lines = cs.session_lines(ss, xd, "card").splitlines()
    assert len(lines) == 7 and all(ln.startswith("[7] ") for ln in lines)
    assert "to its rerun on the plain versions" in lines[3]
    assert "bit for bit" in lines[1] and "[card]" in lines[0]
    assert os.listdir(tmp_path) == ["pages"]
    # the phase's store at the serving launcher's geometry
    geom = cs.session_config().geom
    assert (geom.value_bytes, geom.block_bytes, geom.sst_kvs) == (4096,
                                                                  32768, 256)
    full = cs.get_config("falcon-mamba-7b")   # phase 5's batch of 4
    assert 4 * full.n_layers * ((full.ssm_conv - 1) * full.d_inner * 2 +
                                full.d_inner * full.ssm_state * 4) \
        + 4 * 4 == 146_800_656


def test_chip_smoke_sharded_phase_rehearsal(tmp_path):
    """Phase 8 on the CPU at 1/64 of the paper's SST and L1 sizes (241
    records a memtable): two deterministic rounds, each one stacked
    launch of the 4 shards' same-shape jobs (the first of 4 L0 runs, the
    second of 4 L0 and 4 L1 runs), each job again alone on the plain
    versions, the batched calls held against the plain batched versions
    (also the device sort's), a background round and a YCSB-A mix, every
    acknowledged write read back before and after a reopen; no kernel
    launched (CPU tensors launch none); and the lines it prints."""
    cs = _chip_smoke()
    div = 64
    geom = SSTGeometry(key_bytes=16, value_bytes=272, block_bytes=4096,
                       sst_bytes=4 * 1024 * 1024 // div)
    sched = SchedulerConfig(l0_trigger=4, base_bytes=32 * 1024 * 1024 // div)
    sh = cs.sharded_phase(str(tmp_path), "cpu", geom=geom, sched=sched,
                          bg_ops=2000, sample=300)
    assert sh["per_round"] == 4 * 241 == 4 * cs.memtable_records(geom, 256)
    assert [[b for b, _ in r[:-1]] for r in sh["rounds"]] == \
        [[64] * 4, [128] * 4]
    assert all(batched for r in sh["rounds"] for _, batched in r[:-1])
    det = sh["det_counts"]
    assert det["engine"] == (2, 8, 4) and det["queue"] == (2, 8, 4)
    assert det["stats"].batched_compactions == det["stats"].compactions == 8
    assert [(inputs, live) for inputs, _, live in sh["job_checks"]] == \
        [(4, 964)] * 4 + [(8, 1928)] * 4
    assert [(n, shape) for n, shape, _ in sh["calls"]] == [
        ("merge_runs", (4, 1024, 6)), ("prefix_encode_wire", (4, 1024, 4)),
        ("merge_runs", (4, 2048, 6)), ("prefix_encode_wire", (4, 2048, 4))]
    assert [n for n, _, _ in sh["device_calls"]] == ["bitonic_sort",
                                                     "prefix_encode_wire"]
    assert sh["bg"]["jobs"] > 0 and sh["bg"]["reads"] > 0
    assert sh["bg_counts"]["stats"].compactions == sh["bg"]["jobs"]
    assert sh["scan_rows"] >= 3 * 4 * sh["per_round"]   # + new keys
    assert not any(sh["launches"].values())
    assert "timing" not in sh   # the CUPTI comparison runs on the card
    lines = cs.sharded_lines(sh, "card").splitlines()
    assert len(lines) == 9 and all(ln.startswith("[8] ") for ln in lines)
    assert "merge launches" in lines[1] and "[card]" in lines[2]
    assert sorted(os.listdir(tmp_path)) == ["kept", "kept-bg"]
    # with one checked batch call: a wrong output raises
    rows = torch.zeros((2, 32, 3), dtype=torch.int32)
    good = cs.ref.merge_runs_batched(rows, (16, 16))
    assert cs.check_batch_calls([("merge_runs", (rows, (16, 16)), {}, good,
                                  {})]) == [("merge_runs", (2, 32, 3), 0)]
    with pytest.raises(AssertionError, match="differs from its plain"):
        cs.check_batch_calls([("merge_runs", (rows, (16, 16)), {},
                               good + 1, {})])
