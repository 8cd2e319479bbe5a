"""Background execution (the port of ``repro.core.background``, in part).

* ``BackgroundExecutor`` -- a named worker pool with a ``wait_idle()``
  barrier and first-error capture.
* ``PrefetchReader`` -- a one-thread I/O pipeline the compaction engine
  uses to double-buffer SST file reads against staging and device work
  (the paper's "judicious data movement" applied across the files of a
  job).

The install sequencer and the cross-shard compaction queue come with the
async write path and sharding.  Both primitives are stdlib threading;
their threads are daemons, and ``shutdown``/``close`` joins them.
"""

from __future__ import annotations

import queue
import threading


class BackgroundExecutor:
    """Fixed worker pool draining a FIFO of thunks.

    ``wait_idle()`` blocks until every submitted task has *finished* (not
    merely been dequeued) and re-raises the first task error, which is also
    re-raised on the next ``submit``/``wait_idle`` so background failures
    cannot pass silently.
    """

    def __init__(self, workers: int = 1, name: str = "bg"):
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._pending = 0                             # guarded-by: _lock
        self._error: BaseException | None = None      # guarded-by: _lock
        self._shutdown = False                        # guarded-by: _lock
        self._threads = [
            threading.Thread(target=self._run, name=f"{name}-{i}",
                             daemon=True)
            for i in range(max(1, workers))]
        for t in self._threads:
            t.start()

    def _run(self):
        while True:
            task = self._q.get()
            if task is None:
                return
            fn, args, kwargs = task
            try:
                fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 - captured, re-raised
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                with self._lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.notify_all()

    def submit(self, fn, *args, **kwargs):
        """Enqueue a task.  Never raises a *previous* task's error (a
        raise here would leave the caller's already-published state
        half-done); poll those with ``check()`` or ``wait_idle()``."""
        with self._lock:
            if self._shutdown:
                raise RuntimeError("executor is shut down")
            self._pending += 1
        self._q.put((fn, args, kwargs))

    def check(self):
        """Raise the first captured background error, if any."""
        with self._lock:
            self._raise_pending_error_locked()

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until all submitted work has completed.  Returns False on
        timeout.  Raises the first background error, if any."""
        with self._lock:
            ok = self._idle.wait_for(lambda: self._pending == 0,
                                     timeout=timeout)
            self._raise_pending_error_locked()
            return ok

    def _raise_pending_error_locked(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending

    def shutdown(self, wait: bool = True):
        if wait:
            self.wait_idle()
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join()


class PrefetchReader:
    """Single I/O thread that reads files one step ahead of the consumer.

    ``read_all(paths, read_fn)`` yields images in order; while the caller
    processes image *i* (CRC unpack, H2D staging, device dispatch), the
    reader thread is already pulling image *i+1* off the disk -- the
    double-buffering of host reads against device work from the paper's
    pipeline, applied across the input files of one job.  A read error
    re-raises in the caller, at the file it belongs to.
    """

    def __init__(self):
        self._ex = BackgroundExecutor(workers=1, name="sst-io")

    def read_all(self, paths, read_fn):
        slots: list[dict] = [{} for _ in paths]
        done = [threading.Event() for _ in paths]

        def fetch(i):
            try:
                slots[i]["img"] = read_fn(paths[i])
            except BaseException as e:  # noqa: BLE001
                slots[i]["err"] = e
            finally:
                done[i].set()

        if paths:
            self._ex.submit(fetch, 0)
        for i in range(len(paths)):
            if i + 1 < len(paths):
                self._ex.submit(fetch, i + 1)
            done[i].wait()
            if "err" in slots[i]:
                raise slots[i]["err"]
            yield slots[i]["img"]

    def close(self):
        self._ex.shutdown(wait=True)
