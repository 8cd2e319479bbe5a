"""The background-error taxonomy of the async write path (the port of
``repro.lsm.faults``, its classification only).

:func:`classify` maps an exception to ``"transient"`` (worth retrying:
I/O hiccups) or ``"hard"`` (retrying cannot help: checksum mismatches,
corruption, logic errors).  :class:`BackgroundError` carries that verdict
on the store's ``bg_error``: a failed background flush or compaction
halts the pipeline with one, and ``LsmDB.resume()`` restarts it.

The store does not retry here: a background failure goes straight to
``bg_error``.  ROADMAP A9 brings the rest of the JAX module: the
failpoint registry and ``fire``, ``FaultInjected``, ``SimulatedCrash``,
and the retries with backoff (``backoff_delays``, ``with_retries``) that
act on these workers.
"""

from __future__ import annotations


class BackgroundError(IOError):
    """A classified background failure parked on the store's ``bg_error``.

    ``severity == "transient"`` means the failure class is recoverable:
    ``LsmDB.resume()`` restarts the pipeline.  ``"hard"`` means retrying
    cannot help (corruption, a checksum mismatch, a logic error);
    ``resume()`` still clears the error.
    """

    def __init__(self, op: str, cause: BaseException):
        self.op = op
        self.cause = cause
        self.severity = classify(cause)
        super().__init__(
            f"background {op} failed ({self.severity}): {cause!r}; "
            "call resume() to restart the pipeline")


def classify(err: BaseException) -> str:
    """Severity verdict for a background failure: transient or hard.

    Checksum and corruption failures are hard (retrying re-reads the same
    bad bytes); other I/O errors are transient (the retryable class);
    anything else -- a failed kernel launch, an assertion, a type error
    -- is hard."""
    if isinstance(err, BackgroundError):
        return err.severity
    msg = str(err).lower()
    if "checksum" in msg or "crc" in msg or "corrupt" in msg:
        return "hard"
    if isinstance(err, OSError):
        return "transient"
    return "hard"
