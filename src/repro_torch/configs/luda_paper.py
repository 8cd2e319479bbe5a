"""The paper's own experimental configuration (LUDA §IV-A).

16 B keys, value sizes swept 128 B..1 KB, 4 KB data blocks, 4 MB
SSTs/memtables, 10 bloom bits per key, YCSB-A over a zipfian keyspace.
Scaled presets for the CPU-hosted benchmark harness are derived from this.
(The port's copy of ``repro.configs.luda_paper``, over the port's
geometry, scheduler and workload types.)
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.ycsb import WorkloadSpec


@dataclasses.dataclass(frozen=True)
class LudaPaperConfig:
    value_sizes: tuple[int, ...] = (128, 256, 512, 1024)
    cpu_overheads: tuple[float, ...] = (0.0, 0.4, 0.8)
    bloom_bits_per_key: int = 10
    records: int = 10_000_000          # paper: 10M load + 10M ops
    operations: int = 10_000_000

    def geometry(self, value_size: int) -> SSTGeometry:
        return SSTGeometry(key_bytes=16, value_bytes=value_size + 16,
                           block_bytes=4096, sst_bytes=4 * 1024 * 1024,
                           bloom_bits_per_key=self.bloom_bits_per_key)

    def workload(self, value_size: int, *, records=None, operations=None
                 ) -> WorkloadSpec:
        return WorkloadSpec.ycsb_a(
            records=records or self.records,
            operations=operations or self.operations,
            value_size=value_size)

    def scheduler(self) -> SchedulerConfig:
        return SchedulerConfig(l0_trigger=4,
                               base_bytes=8 * 4 * 1024 * 1024)


PAPER = LudaPaperConfig()

# CPU-container scale-down (same ratios: DB ~ 50 MB instead of 5 GB)
BENCH_SCALE = LudaPaperConfig(records=40_000, operations=40_000)


def bench_geometry(value_size: int) -> SSTGeometry:
    """Scaled geometry: 64 KB SSTs keep compaction job sizes proportional
    to the scaled dataset."""
    return SSTGeometry(key_bytes=16, value_bytes=value_size + 16,
                       block_bytes=4096, sst_bytes=64 * 1024,
                       bloom_bits_per_key=10)
