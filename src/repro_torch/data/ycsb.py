"""YCSB workload generator (Cooper et al., SoCC'10) -- the paper's driver.
(A copy of ``repro.data.ycsb``: the same seed gives the same streams.)

Implements the load phase and workloads A (50/50 update/read, the paper's
setting), B (95/5), C (read-only) and D (95/5 read-latest/insert) with
zipfian (Gray et al.'s rejection-free generator, as in the YCSB reference
implementation), uniform, and latest request distributions.  Keys are
16 B (``user%012d``), values are configurable (the paper sweeps
128 B..1 KB).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

ZIPF_CONST = 0.99


class ZipfianGenerator:
    """Gray's zipfian generator over [0, n)."""

    def __init__(self, n: int, theta: float = ZIPF_CONST, seed: int = 0):
        self.n = n
        self.theta = theta
        self.rng = np.random.default_rng(seed)
        self.alpha = 1.0 / (1.0 - theta)
        self.zetan = self._zeta(n)
        self.zeta2 = self._zeta(2)
        self.eta = ((1 - (2.0 / n) ** (1 - theta)) /
                    (1 - self.zeta2 / self.zetan))

    def _zeta(self, n: int) -> float:
        return float(np.sum(1.0 / np.arange(1, n + 1) ** self.theta))

    def sample(self, size: int | None = None) -> np.ndarray:
        u = self.rng.random(size if size is not None else ())
        uz = u * self.zetan
        out = np.where(
            uz < 1.0, 0,
            np.where(uz < 1.0 + 0.5 ** self.theta, 1,
                     (self.n * (self.eta * u - self.eta + 1.0)
                      ** self.alpha).astype(np.int64)))
        return np.clip(out, 0, self.n - 1)


@dataclasses.dataclass
class WorkloadSpec:
    name: str = "A"
    read_fraction: float = 0.5
    update_fraction: float = 0.5
    insert_fraction: float = 0.0    # workload D: new records mid-run
    records: int = 10_000
    operations: int = 10_000
    value_size: int = 256
    distribution: str = "zipfian"   # "zipfian" | "uniform" | "latest"
    seed: int = 42

    @classmethod
    def ycsb_a(cls, **kw):
        return cls(name="A", read_fraction=0.5, update_fraction=0.5, **kw)

    @classmethod
    def ycsb_b(cls, **kw):
        return cls(name="B", read_fraction=0.95, update_fraction=0.05, **kw)

    @classmethod
    def ycsb_c(cls, **kw):
        return cls(name="C", read_fraction=1.0, update_fraction=0.0, **kw)

    @classmethod
    def ycsb_d(cls, **kw):
        """Read latest: 95% reads skewed toward recent inserts, 5%
        inserts of new records (YCSB's ``workloadd``)."""
        kw.setdefault("distribution", "latest")
        return cls(name="D", read_fraction=0.95, update_fraction=0.0,
                   insert_fraction=0.05, **kw)

    @classmethod
    def named(cls, name: str, **kw) -> "WorkloadSpec":
        ctor = {"A": cls.ycsb_a, "B": cls.ycsb_b,
                "C": cls.ycsb_c, "D": cls.ycsb_d}.get(name.upper())
        if ctor is None:
            raise ValueError(f"unknown YCSB workload {name!r} "
                             "(expected A, B, C or D)")
        return ctor(**kw)


def key_of(i: int) -> bytes:
    # fnv-scramble the id so the zipfian head is spread over the key space
    # (YCSB hashes record ids the same way)
    h = (i * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFF
    return b"user%012x" % h


class YCSBWorkload:
    def __init__(self, spec: WorkloadSpec):
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed)
        if spec.distribution in ("zipfian", "latest"):
            # "latest" draws a zipfian *offset from the newest record*
            self.chooser = ZipfianGenerator(spec.records, seed=spec.seed + 1)
        elif spec.distribution == "uniform":
            self.chooser = None
        else:
            raise ValueError(
                f"unknown distribution {spec.distribution!r} "
                "(expected zipfian, uniform or latest)")

    def _value(self, i: int) -> bytes:
        width = self.spec.value_size
        body = (b"%016d" % i) * (width // 16 + 1)
        return body[:width]

    def load_ops(self) -> Iterator[tuple[str, bytes, bytes]]:
        """Insert every record once (YCSB load phase)."""
        for i in range(self.spec.records):
            yield "insert", key_of(i), self._value(i)

    def run_ops(self) -> Iterator[tuple[str, bytes, bytes | None]]:
        """The transaction phase: reads, updates and (workload D) inserts
        per the workload mix.  With the ``latest`` distribution the
        record id is drawn as ``newest - zipf()`` so the skew tracks the
        moving insert frontier, as in the YCSB reference."""
        spec = self.spec
        n_records = spec.records     # grows as workload-D inserts land
        if self.chooser is not None:
            draws = self.chooser.sample(spec.operations)
        else:
            draws = self.rng.integers(0, spec.records, spec.operations)
        kinds = self.rng.random(spec.operations)
        for op_i in range(spec.operations):
            if spec.distribution == "latest":
                rid = max(0, n_records - 1 - int(draws[op_i]))
            else:
                rid = int(draws[op_i])
            kind = kinds[op_i]
            if kind < spec.read_fraction:
                yield "read", key_of(rid), None
            elif kind < spec.read_fraction + spec.insert_fraction:
                yield "insert", key_of(n_records), self._value(n_records)
                n_records += 1
            else:
                yield "update", key_of(rid), self._value(op_i)
