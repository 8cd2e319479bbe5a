"""Compaction scheduling: LevelDB's leveling policy, and the shape key
that lets jobs share a stacked launch (a copy of ``repro.core.scheduler``).

Picks which SSTs feed the (device or CPU) compaction engine:

* L0 compacts when it holds >= ``l0_trigger`` files (L0 files overlap, so
  *all* overlapping L0 files join the job);
* L(i>=1) compacts when its byte size exceeds ``base_bytes * ratio**i``;
  one file is picked round-robin (compaction pointer), plus every
  overlapping file in L(i+1).

``paper_faithful=True`` reproduces the prototype artifact the paper
acknowledges (§IV-C): compaction only triggers on a full L0 and pending
memtable dumps are *not* folded into the running job, which widens the next
job's overlap -- measurably more compaction data, as in Fig. 11.
"""

from __future__ import annotations

import dataclasses

from repro_torch.lsm.sstable import FileMeta
from repro_torch.lsm.version import NUM_LEVELS, Version


@dataclasses.dataclass
class CompactionJob:
    level: int                       # inputs come from `level` and `level+1`
    inputs_lo: list[FileMeta]        # files at `level`
    inputs_hi: list[FileMeta]        # overlapping files at `level+1`
    bottom_level: bool               # no deeper data -> tombstones collect

    @property
    def all_inputs(self):
        return self.inputs_lo + self.inputs_hi

    @property
    def bytes_in(self) -> int:
        return sum(f.size_bytes for f in self.all_inputs)


def batch_signature(block_counts, bottom_level: bool,
                    sort_mode: str = "merge") -> tuple:
    """Shape-bucket key for batched device launches.

    Jobs whose signatures are equal present identical array shapes (and,
    in merge mode, identical run lengths) after the engine's pow2 padding,
    so they can stack into one launch
    (``TorchCompactionEngine.compact_many``).  ``block_counts`` are the
    per-input SST block counts of one job.

    * merge mode: each input run is padded to a pow2 block count and the
      total to a pow2 bucket, so the key is (per-run padded counts, bucket,
      bottom_level);
    * re-sort modes ignore run structure: only the padded total matters.
    """
    from repro_torch.core.offload import next_pow2
    if sort_mode == "merge":
        padded = tuple(next_pow2(b) for b in block_counts)
        return (padded, next_pow2(sum(padded)), bool(bottom_level))
    return ((), next_pow2(sum(block_counts)), bool(bottom_level))


@dataclasses.dataclass
class SchedulerConfig:
    l0_trigger: int = 4
    base_bytes: int = 8 * 4 * 1024 * 1024   # L1 quota
    ratio: int = 10
    paper_faithful: bool = False


class CompactionScheduler:
    def __init__(self, cfg: SchedulerConfig | None = None):
        self.cfg = cfg or SchedulerConfig()
        self.compact_pointer: dict[int, bytes] = {}

    def level_quota(self, level: int) -> int:
        return self.cfg.base_bytes * (self.cfg.ratio ** max(0, level - 1))

    def needs_compaction(self, v: Version) -> bool:
        return self.pick(v) is not None

    def debt(self, v: Version) -> float:
        """Compaction debt: summed score excess over the trigger across
        levels (0.0 = nothing owed; 1.0 = one full level-trigger worth of
        overdue compaction).  Sampled as the ``lsm.compaction.debt``
        gauge on every state transition -- the tail-latency early-warning
        signal (debt climbs before write stalls appear)."""
        return sum(max(0.0, self.score(v, lvl) - 1.0)
                   for lvl in range(NUM_LEVELS - 1))

    def score(self, v: Version, level: int) -> float:
        if level == 0:
            return len(v.levels[0]) / self.cfg.l0_trigger
        return v.level_bytes(level) / self.level_quota(level)

    def pick(self, v: Version) -> CompactionJob | None:
        best_level, best_score = -1, 1.0
        for level in range(NUM_LEVELS - 1):
            s = self.score(v, level)
            if s >= best_score:
                best_level, best_score = level, s
        if best_level < 0:
            return None
        return self._build_job(v, best_level)

    def _build_job(self, v: Version, level: int) -> CompactionJob:
        if level == 0:
            # every L0 file may overlap: take them all, expanded transitively
            files = list(v.levels[0])
            if not files:
                return None
            smallest = min(f.smallest for f in files)
            largest = max(f.largest for f in files)
        else:
            files = self._pick_round_robin(v, level)
            smallest = min(f.smallest for f in files)
            largest = max(f.largest for f in files)
        hi = v.overlapping(level + 1, smallest, largest)
        bottom = all(not v.levels[d] for d in range(level + 2, NUM_LEVELS))
        self.compact_pointer[level] = largest
        return CompactionJob(level=level, inputs_lo=files, inputs_hi=hi,
                             bottom_level=bottom)

    def _pick_round_robin(self, v: Version, level: int) -> list[FileMeta]:
        files = v.levels[level]
        ptr = self.compact_pointer.get(level, b"")
        for f in files:
            if f.largest > ptr:
                return [f]
        return [files[0]]
