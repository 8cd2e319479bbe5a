"""Build, load and launch the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface, so they are compiled
by ``nvcc`` into one shared library, bound with ``ctypes``, at first use
(route (b) of the build: seconds per file, no PyTorch headers).  Each
``.cu`` file compiles in its own ``nvcc`` process, all started together,
then one link.  The library lands in ``build/kernels/<digest>/`` under the
repository root (listed in ``.gitignore``); the digest covers the sources
and the flags, so an edited source builds anew.  Nothing is built when the
module is imported: the CPU tests import every module.

Every launch goes through :func:`launch`, which checks the launch's error
code and counts the launch under the kernel's name.  The async store
launches from its flush and compaction workers and from reader threads at
once, so the build and the counts are taken under a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("crc32.cu", "merge_path.cu", "prefix.cu", "bloom.cu", "lookup.cu",
           "bitonic.cu", "selective_scan.cu", "selective_scan_bwd.cu")
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry points: (argtypes); every one returns a cudaError_t as int
SIGNATURES = {
    "crc32_sections": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I,
                       ctypes.c_uint32, _P, _LL, _P),
    "merge_runs": (_P, _P, _P, _I, _I, _P, _I, _I, _LL, _P),
    "prefix_encode": (_P, _LL, _I, _I, _P, _LL, _P, _P, _P),
    "bloom_build": (_P, _P, _LL, _I, _I, _I, _I, _I, _P, _P),
    "bloom_multi_probe": (_P, _P, _LL, _I, _I, _I, _P, _P),
    "bloom_query": (_P, _P, _LL, _LL, _I, _I, _I, _P, _P),
    "lookup_blocks": (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _P, _P),
    "bitonic_sort": (_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P, _P, _P,
                     _P),
    "selective_scan": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _P),
    "selective_scan_bwd": (_P, _I) + (_P,) * 22 + (_I,) * 5 + (_P,),
}

#: Launches per kernel since the last :func:`reset_launch_counts`.
LAUNCHES = {name: 0 for name in SIGNATURES}

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()     # one build, whichever thread comes first
_count_lock = threading.Lock()   # launches counted from several threads
_all_launches = 0                # since import, every thread (under the lock)
_thread = threading.local()      # ``.launches``: this thread's, since import
build_seconds: float | None = None   # wall time of the build (None: cached)


def repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def build_dir() -> Path:
    return repo_root() / "build" / "kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _digest() -> str:
    h = hashlib.sha256()
    headers = tuple(sorted(p.name for p in CSRC.glob("*.cuh")))
    for name in headers + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    """nvcc every source in parallel, then link one shared library; the
    compiler's output (ptxas register and spill counts) goes to
    ``build.log`` beside it."""
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            cmd = [nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                   str(CSRC / src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs, failed = [], [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src} (exit {p.returncode})\n{out}")
            objs.append(obj)
            if p.returncode != 0:
                failed.append(src)
        if not failed:
            tmp_lib = os.path.join(tmp, LIB_NAME)
            link = subprocess.run(
                [nvcc(), *ARCH_FLAGS, "-shared", "-o", tmp_lib, *objs],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link (exit {link.returncode})\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
            else:
                os.replace(tmp_lib, out_dir / LIB_NAME)
        (out_dir / "build.log").write_text("".join(log))
    if failed:
        raise RuntimeError(f"CUDA kernel build failed ({', '.join(failed)}):"
                           "\n" + "".join(log))


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _load()
    return _lib


def _load() -> ctypes.CDLL:
    """Build the library if this digest has none yet, then bind it."""
    global build_seconds
    out_dir = build_dir() / _digest()
    path = out_dir / LIB_NAME
    if not path.exists():
        t0 = time.perf_counter()
        _compile(out_dir)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    return (build_dir() / _digest() / "build.log").read_text()


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, *args, launched: ctypes.c_int | None = None) -> None:
    """Call C entry point ``name`` (which launches its kernels on the
    current stream), raise on its error code, and count the launches: one,
    or, for an entry point that enqueues several kernels, the number it
    wrote to ``launched`` (passed to it by address)."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} "
                           f"(error {err})")
    n = 1 if launched is None else launched.value
    global _all_launches
    with _count_lock:
        LAUNCHES[name] += n
        _all_launches += n
    _thread.launches = getattr(_thread, "launches", 0) + n


def launch_marks() -> tuple[int, int]:
    """``(launches by every thread, launches by this thread)`` since
    import.  Two readings bracket a stretch of this thread's work: another
    thread launched in it when the first count grew more than the
    second."""
    with _count_lock:
        total = _all_launches
    return total, getattr(_thread, "launches", 0)


def launch_counts() -> dict[str, int]:
    with _count_lock:
        return dict(LAUNCHES)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype,
               ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``ndim`` dimensions (what the C entry points take)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
