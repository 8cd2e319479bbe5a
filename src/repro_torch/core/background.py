"""Background execution (the port of ``repro.core.background``, in part).

* ``BackgroundExecutor`` -- a named worker pool with a ``wait_idle()``
  barrier and first-error capture.  The async store's flush workers and
  its compaction worker run here, so ``put()`` never waits for the card.
* ``InstallSequencer`` -- a ticket lock that serializes SST installs in
  memtable-rotation order.  Flush workers may build L0 images at the
  same time (``flush_workers=N``), but L0 reads resolve key versions by
  file number, so installs must land newest-memtable-last.
* ``GlobalCompactionQueue`` -- the cross-shard compaction coordinator
  behind ``ShardedDB``: shards publish that they have work, one worker
  drains them in rounds through the shared engine's ``compact_many``.
* ``PrefetchReader`` -- a one-thread I/O pipeline the compaction engine
  uses to double-buffer SST file reads against staging and device work
  (the paper's "judicious data movement" applied across the files of a
  job).

The primitives are stdlib threading; their threads are daemons, and
``shutdown``/``close`` joins or stops them.  A worker thread launches on
the current device's default stream, which every thread of the process
shares, so work that one thread queues on the card is ordered with the
work another queues after it.
"""

from __future__ import annotations

import queue
import threading
import time

from repro_torch.lsm import faults


def remaining(deadline: float | None) -> float | None:
    """Seconds left until a ``time.monotonic()`` deadline (None: no
    deadline), never below 0."""
    return None if deadline is None else max(0.0, deadline - time.monotonic())


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


class InstallSequencer:
    """Hands out increasing tickets; ``wait_turn(t)`` blocks until every
    ticket below ``t`` has called ``done(t')``.  Serializes L0 installs in
    rotation order while letting the image builds overlap.  A holder must
    call ``done`` for its ticket, also when its work failed, or every
    later ticket waits for ever (``wait_turn`` has no timeout)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._next_ticket = 0                         # guarded-by: _lock
        self._next_install = 0                        # guarded-by: _lock

    def issue(self) -> int:
        with self._lock:
            t = self._next_ticket
            self._next_ticket += 1
            return t

    def wait_turn(self, ticket: int):
        with self._cv:
            self._cv.wait_for(lambda: self._next_install == ticket)

    def done(self, ticket: int):
        with self._cv:
            assert self._next_install == ticket
            self._next_install += 1
            self._cv.notify_all()


class GlobalCompactionQueue:
    """Cross-shard compaction coordinator (the ``ShardedDB`` backend).

    Shards publish "I have compaction work" notifications
    (``LsmDB(compaction_sink=queue.notify)``); one worker drains the
    queue in rounds: each round picks at most ONE job per pending shard
    (jobs within a shard are ordered -- installing one changes what the
    next should be -- but jobs from different shards are independent)
    and hands the whole round to ``engine.compact_many``, which stacks
    same-signature jobs into one batched launch.  Installs then run per
    shard in pick order, so each shard's version history is exactly what
    sequential compaction would have produced.

    A failed install (a CRC verdict) is isolated to its shard: the other
    jobs of the round still install, and the first error re-raises
    through the executor (on ``wait_idle``).  The worker launches on the
    current device's default stream, as the caller's thread does.

    ``tracer`` records each round as a ``compact.round`` span (args
    ``shards``, ``jobs``) around its ``compact_many`` and installs;
    ``metrics`` holds the ``compact.queue.depth`` gauge (shards with
    pending work), sampled onto a counter track too.
    """

    def __init__(self, engine, tracer=None, metrics=None):
        from repro_torch.obs.metrics import NULL_REGISTRY
        from repro_torch.obs.trace import NULL_TRACER
        self.engine = engine
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else NULL_REGISTRY
        self._lock = threading.Lock()
        # id(db) -> db
        self._pending: dict[int, object] = {}   # guarded-by: _lock
        self._scheduled = False                 # guarded-by: _lock
        self._closed = False                    # guarded-by: _lock
        self._exec = BackgroundExecutor(workers=1, name="shard-compact")
        # accounting: written by the drain worker, read by the caller
        self.rounds = 0                         # guarded-by: _lock
        self.jobs_run = 0                       # guarded-by: _lock
        self.trivial_moves = 0                  # guarded-by: _lock
        self._g_depth = self.metrics.gauge(
            "compact.queue.depth",
            help="shards with pending compaction work")

    def _sample_depth_locked(self):
        depth = len(self._pending)
        self._g_depth.set(depth)
        if self.tracer.enabled:
            self.tracer.counter("compact.queue.depth", depth)

    def notify(self, db):
        """Mark ``db`` as having (possible) compaction work and make sure
        the drain worker runs.  Callable as a ``compaction_sink``."""
        with self._lock:
            if self._closed:
                return
            self._pending[id(db)] = db
            self._sample_depth_locked()
            if self._scheduled:
                return
            self._scheduled = True
        try:
            self._exec.submit(self._drain)
        except BaseException:
            with self._lock:
                self._scheduled = False
            raise

    def _drain(self):
        try:
            while True:
                with self._lock:
                    dbs = list(self._pending.values())
                    self._pending.clear()
                    self._sample_depth_locked()
                    if not dbs:
                        self._scheduled = False
                        return
                self._drain_round(dbs)
        except BaseException:
            with self._lock:
                self._scheduled = False
            raise

    def _drain_round(self, dbs):
        """Pick <= 1 real job a shard, compact them together, install per
        shard.  Shards that yielded a job are queued again (they may have
        more).  The failpoint ``compact.round`` fires first."""
        faults.fire("compact.round")
        owners, jobs = [], []
        for db in dbs:
            job = db.pick_compaction()
            # trivial moves only touch metadata: apply inline and pick
            # again (bounded: each move shrinks the source level)
            guard = 0
            while job is not None and db.is_trivial_move(job) and guard < 64:
                db.apply_trivial_move(job)
                with self._lock:
                    self.trivial_moves += 1
                job = db.pick_compaction()
                guard += 1
            if job is not None:
                owners.append((db, job))
                jobs.append(([f.path for f in job.all_inputs],
                             job.bottom_level))
        if not jobs:
            return
        with self._lock:
            self.rounds += 1
            self.jobs_run += len(jobs)
        with self.tracer.span("compact.round", shards=len(dbs),
                              jobs=len(jobs)):
            results = self.engine.compact_many(jobs)
            err = None
            for (db, job), (out, es) in zip(owners, results):
                try:
                    db.apply_compaction(job, out, es)
                except BaseException as e:  # noqa: BLE001 - per shard
                    if err is None:
                        err = e
                with self._lock:
                    if not self._closed:
                        self._pending[id(db)] = db
                        self._sample_depth_locked()
        if err is not None:
            raise err

    def wait_idle(self, timeout: float | None = None):
        """Barrier: returns once no shard has pending compaction work.
        Re-raises the first background error; raises ``TimeoutError``
        when ``timeout`` seconds pass first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if not self._exec.wait_idle(timeout=remaining(deadline)):
                raise TimeoutError("compaction queue still busy after "
                                   f"{timeout} s")
            resubmit = False
            with self._lock:
                if not self._pending and not self._scheduled:
                    return
                if not self._scheduled:
                    # a previous drain died with work still queued (its
                    # error already surfaced above); restart it
                    self._scheduled = True
                    resubmit = True
            if resubmit:
                self._exec.submit(self._drain)

    def close(self):
        with self._lock:
            self._closed = True
            self._pending.clear()
        self._exec.shutdown(wait=False)


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
