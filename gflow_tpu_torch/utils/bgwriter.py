"""Deferred file IO: a single background worker thread for diagnostic
PNG/video writes.

Copy of ``gflow_tpu/utils/bgwriter.py``, with a busy counter. Encoding
and writing the per-stage diagnostic images and videos is host work that
the next device stage does not depend on; zlib and PIL release the GIL, so a worker
thread overlaps it with the main thread's waits on the device.

Writes are ordered (one queue, one worker). Errors are captured and
re-raised on the next flush() so they are not silently lost. Callers must
flush() before reading anything they submitted (fit_video flushes once at
the end of the run). ``busy_s`` counts the seconds the worker has spent
inside jobs, timed on the worker's thread, so that a phase of the main
thread can read how long the writer ran beside it.
"""
from __future__ import annotations

import queue
import threading
import time


class BackgroundWriter:
    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._err = None
        self._busy = 0.0     # seconds inside finished jobs
        self._since = None   # perf_counter at the running job's start
        self._clock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            fn, args, kwargs = self._q.get()
            with self._clock:
                self._since = time.perf_counter()
            try:
                if fn is not None:
                    fn(*args, **kwargs)
            except Exception as e:  # surfaced at the next flush()
                if self._err is None:
                    self._err = e
            finally:
                with self._clock:
                    self._busy += time.perf_counter() - self._since
                    self._since = None
                self._q.task_done()

    @property
    def busy_s(self) -> float:
        """Seconds the worker has spent inside jobs, the running one's so
        far included."""
        with self._clock:
            since = self._since
            return self._busy + (time.perf_counter() - since if since is not None else 0.0)

    def submit(self, fn, *args, **kwargs):
        """Enqueue fn(*args, **kwargs). Arguments must not be mutated by the
        caller afterwards (pass copies of any mutable host buffers)."""
        self._q.put((fn, args, kwargs))

    def flush(self):
        """Block until every submitted write has completed; re-raise the
        first error seen since the previous flush."""
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err


_writer = None
_lock = threading.Lock()


def get_writer() -> BackgroundWriter:
    global _writer
    with _lock:
        if _writer is None:
            _writer = BackgroundWriter()
            # the worker is a daemon thread — drain it at interpreter exit
            # so direct GFlowTrainer users (no fit_video end-of-run flush)
            # don't lose queued writes when the process ends
            import atexit

            atexit.register(flush_writes)
        return _writer


def flush_writes():
    """Flush the global writer if one was ever created."""
    if _writer is not None:
        _writer.flush()


def writer_busy_s() -> float:
    """The global writer's ``busy_s``; 0 if none was ever created."""
    return _writer.busy_s if _writer is not None else 0.0
