"""The port's dry run (``repro_torch.launch.dryrun``) and its tables
(``repro_torch.roofline.analysis``) against the JAX package's (ROADMAP
A16).

Small cells run for real here: a train, a prefill and a decode cell of the
smoke falcon-mamba-7b, gemma3-4b and granite-moe-3b-a800m on a fake (4, 2)
world, the compaction cell at 8 blocks a shard, and phase 15 of
``chip_smoke.py`` at the smoke config, all with ``device="cpu"`` in one
subprocess that owns the fake world's process group.  JAX's
``repro.roofline.analysis`` reads the records they write.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.roofline import analysis as jax_analysis
from repro_torch.configs.luda_paper import PAPER
from repro_torch.core import compaction
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis, constants

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("falcon-mamba-7b", "gemma3-4b", "granite-moe-3b-a800m")
KINDS = ("train", "prefill", "decode")
SMALL_BLOCKS = 8
KINDS_OF_COLLECTIVES = {"all-gather", "all-reduce", "reduce-scatter",
                        "all-to-all", "collective-permute"}

CELLS_CODE = r"""
import importlib.util, json, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
ARCHS, BLOCKS, out_path = json.loads(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
SHAPES = [ShapeSpec("train_s", "train", 16, 8),
          ShapeSpec("prefill_s", "prefill", 16, 8),   # the smoke ring: 16
          ShapeSpec("decode_s", "decode", 32, 8)]
cells = {}
for arch in ARCHS:
    cfg = get_smoke_config(arch).with_(dtype="bfloat16")
    for shape in SHAPES:
        rec = dryrun.lm_cell(cfg, shape, (4, 2), ("data", "model"), "cpu")
        rec.update(arch=arch, shape=shape.name,
                   cell=dryrun.cell_name(arch, shape.name, False))
        cells[rec["cell"]] = rec
rec = dryrun.run_compaction_cell(False, BLOCKS, device="cpu")
rec["cell"] = dryrun.cell_name("luda-compaction", "paper", False)
cells[rec["cell"]] = rec

# phase 15 of chip_smoke.py at the smoke config
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
cfg = get_smoke_config("falcon-mamba-7b").with_(dtype="bfloat16")
cell = lambda: dict(dryrun.lm_cell(cfg, ShapeSpec("decode_s", "decode", 32,
                                                  8), (4, 2),
                                   ("data", "model"), "cpu"), cell="small")
p15 = cs.dry_phase(torch.device("cpu"), configs={"train": cfg, "serve": cfg},
                   sizes={"train": dict(batch=2, seq=16),
                          "prefill": dict(batch=2, prompt_len=16),
                          "compact": dict(blocks=BLOCKS)}, cell=cell)
lines = [l for part in ("train", "prefill", "compact")
         for l in cs.dry_part_lines(part, p15[part], "cpu")]
lines += cs.dry_part_lines("cell", p15, "cpu")
phase = {part: dict(flops=p15[part]["rec"]["cost"]["flops_per_device"],
                    real=p15[part]["real"]["flops"],
                    arg_bytes=p15[part]["arg_bytes"],
                    rec_arg_bytes=p15[part]["rec"]["memory"]["argument_bytes"])
         for part in ("train", "prefill")}
json.dump({"cells": cells, "phase": phase, "lines": lines,
           "stats": p15["compact"]["rec"]["stats"]}, open(out_path, "w"))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The small cells and the phase-15 rehearsal, in one subprocess."""
    path = tmp_path_factory.mktemp("dryrun") / "out.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", CELLS_CODE, json.dumps(ARCHS),
                    str(SMALL_BLOCKS), str(path)], env=env, check=True,
                   timeout=600, cwd=REPO)
    return json.loads(path.read_text())


CELL_NAMES = [dryrun.cell_name(a, f"{k}_s", False) for a in ARCHS
              for k in KINDS]


@pytest.mark.parametrize("name", CELL_NAMES)
def test_small_cells_write_well_formed_records(run, name):
    r = run["cells"][name]
    assert "error" not in r, r.get("traceback")
    assert r["mesh"] == {"shape": {"data": 4, "model": 2}, "devices": 8}
    assert r["kind"] == name.split("--")[1][:-2]
    m = r["memory"]
    assert m["alias_bytes"] == 0 and m["hbm_per_chip"] == 80 * 10**9
    assert m["peak_estimate_bytes"] == (m["argument_bytes"]
                                        + m["output_bytes"]
                                        + m["temp_bytes"])
    assert m["fits"] == (m["peak_estimate_bytes"] < constants.HBM_PER_CHIP)
    assert min(m["argument_bytes"], m["output_bytes"]) > 0
    c = r["cost"]
    assert c["flops_per_device"] > 0 and c["bytes_per_device"] > 0
    assert c["flops_global"] == 8 * c["flops_per_device"]
    assert c["bytes_global"] == 8 * c["bytes_per_device"]
    assert c["dot_flop_stats"]["flops"] == c["flops_per_device"]
    assert "cost_analysis_flops_per_device" not in c
    kinds = {k for k in r["collectives"] if k != "total_bytes"}
    assert kinds <= KINDS_OF_COLLECTIVES and kinds
    assert r["collectives"]["total_bytes"] == sum(
        r["collectives"][k]["bytes"] for k in kinds)
    rl = r["roofline"]
    assert rl["compute_s"] == c["flops_per_device"] / 989.4e12
    assert rl["memory_s"] == c["bytes_per_device"] / 3.35e12
    assert math.isclose(rl["collective_s"], sum(
        r["collectives"][k]["seconds"] for k in kinds))
    assert rl["dominant"] == max(("compute_s", "memory_s", "collective_s"),
                                 key=lambda k: rl[k])
    assert r["useful_flops_ratio"] == r["model_flops"] / c["flops_global"]
    assert r["compile_seconds"] > 0 and r["device"] == "cpu"


def test_compaction_cell_stats_equal_compact(run):
    """The cell's one shard against ``compaction.compact`` of the same
    image (the plain versions on the CPU), and the mesh's totals."""
    r = run["cells"][dryrun.cell_name("luda-compaction", "paper", False)]
    geom = PAPER.geometry(256)
    img = dryrun.compaction_image(SMALL_BLOCKS, geom, 0, "cpu")
    _, stats = compaction.compact(img, geom=geom, sort_mode="device")
    assert r["stats"] == stats._asdict() == run["stats"]
    assert stats.crc_ok and stats.n_dropped > 0
    assert r["entries_global"] == 256 * SMALL_BLOCKS * geom.block_kvs
    assert r["wire_bytes_global"] == \
        256 * SMALL_BLOCKS * geom.wire_words_per_block * 4
    assert r["memory"]["argument_bytes"] == sum(
        a.numel() * a.element_size() for a in img)
    assert r["cost"]["flops_per_device"] == 0
    assert r["cost"]["bytes_per_device"] > 2 * r["memory"]["argument_bytes"]
    # a placed image moves nothing
    assert r["collectives"] == {"total_bytes": 0}
    assert r["roofline"]["dominant"] == "memory_s"
    assert r["job_seconds"] > 0


def test_phase_15_rehearsal_holds_the_dry_run_to_real_steps(run):
    """``chip_smoke.dry_phase`` on the CPU: the traced (1, 1) cells' dot
    FLOPs and argument bytes equal the real steps' (it raises
    otherwise)."""
    for part, r in run["phase"].items():
        assert r["flops"] == r["real"] > 0, part
        assert r["arg_bytes"] == r["rec_arg_bytes"] > 0, part
    assert any(line.startswith("[15] (d) small") for line in run["lines"])


def records(run, tmp_path):
    """The small cells, a skipped one and an errored one, as files."""
    cells = dict(run["cells"])
    cells["yi-34b--long_500k--pod1"] = {"skipped": "pure full-attention "
                                        "arch", "cell":
                                        "yi-34b--long_500k--pod1"}
    cells["x--y--pod1"] = {"error": "ValueError: x", "traceback": "",
                           "cell": "x--y--pod1"}
    for name, rec in cells.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    return str(tmp_path)


def test_jax_analysis_reads_the_port_records(run, tmp_path):
    """JAX's ``load_cells``, tables and summary read the port's files;
    the port's equal JAX's but for the capacity and the levers."""
    d = records(run, tmp_path)
    jcells, tcells = jax_analysis.load_cells(d), analysis.load_cells(d)
    assert jcells == tcells and len(tcells) == len(run["cells"]) + 2
    jt, tt = jax_analysis.dryrun_table(jcells), analysis.dryrun_table(tcells)
    assert tt == jt.replace("fits 16G", "fits 80 GB")
    assert tt.count("\n") == len(tcells) + 1
    jr, tr = (f(tcells) for f in (jax_analysis.roofline_table,
                                  analysis.roofline_table))
    for jl, tl in zip(jr.splitlines(), tr.splitlines(), strict=True):
        assert jl.rsplit("|", 2)[0] == tl.rsplit("|", 2)[0]
    js, ts = jax_analysis.summarize(jcells), analysis.summarize(tcells)
    assert ts == js.replace("fit 16 GiB", "fit 80 GB")
    assert "1 errors" in ts and "1 documented skips" in ts
    assert not any(w in " ".join(analysis.LEVERS.values())
                   for w in ("MXU", "VMEM", "Pallas"))


def test_cli_writes_a_skip_record_and_refuses_no_cell(tmp_path, capsys):
    dryrun.main(["--device", "cpu", "--arch", "yi-34b", "--shape",
                 "long_500k", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "yi-34b--long_500k--pod1.json").read_text())
    assert "pure full-attention" in rec["skipped"]
    assert "SKIP" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(["--device", "cpu", "--arch", "yi-34b"])


def test_run_and_save_records_a_cell_that_errors(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise ValueError("no such layer")
    monkeypatch.setattr(dryrun, "run_lm_cell", broken)
    rec = dryrun.run_and_save("yi-34b", "train_4k", True, str(tmp_path),
                              device="cpu")
    assert rec["error"] == "ValueError: no such layer"
    assert rec["cell"] == "yi-34b--train_4k--pod2"
    assert json.loads((tmp_path / "yi-34b--train_4k--pod2.json").read_text()
                      ) == rec
    assert dryrun.run_and_save("yi-34b", "train_4k", True, str(tmp_path),
                               skip_existing=True) == rec


def test_rank0_shards_round_up():
    from repro_torch.distributed import partition
    m = partition.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert dryrun.shard_shape((64, 100, 7), (("pod", "data"), "model"),
                              m) == (2, 7, 7)
    assert dryrun.shard_shape((5,), (), m) == (5,)
    structs = {"w": ((64, 100), torch.bfloat16),
               "b": torch.empty((3,), device="meta")}
    specs = {"w": (("pod", "data"), "model"), "b": ()}
    assert dryrun.argument_bytes(structs, specs, m) == 2 * 7 * 2 + 3 * 4
