"""Deferred file IO: a small pool of background worker threads ("lanes")
for diagnostic PNG/video writes.

Counterpart of ``gflow_tpu/utils/bgwriter.py`` (one worker thread), with
lanes and a busy counter. Encoding and writing the per-stage diagnostic
images and videos is host work that the next device stage does not
depend on; zlib and PIL release the GIL, so the lanes encode in parallel
and overlap it with the main thread's waits on the device.

The lanes: ``min(MAX_LANES, usable CPUs)`` worker threads, each with its
own FIFO queue. Unkeyed jobs (``submit``) all go to lane 0, so they run in
submission order among themselves. Keyed jobs (``submit_keyed``, the key
being the output path) are dealt round-robin over the lanes, except that
a key with a job still pending goes to that job's lane: two jobs of one
key run in submission order, so the last write of a file wins.

Errors are captured and re-raised on the next flush() so they are not
silently lost. Callers must flush() before reading anything they
submitted (fit_video flushes once at the end of the run). ``busy_s``
counts the seconds the lanes have spent inside jobs, summed over lanes
and timed on their threads, so that a phase of the main thread can read
how long the writer ran beside it; ``backlog`` counts the jobs submitted
and not yet finished.
"""
from __future__ import annotations

import os
import queue
import threading
import time

MAX_LANES = 4


def lane_count() -> int:
    """The lanes a writer runs: the CPUs this process may use, at most
    MAX_LANES."""
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        cpus = os.cpu_count() or 1
    return max(1, min(MAX_LANES, cpus))


class BackgroundWriter:
    def __init__(self):
        n = lane_count()
        self._queues = [queue.Queue() for _ in range(n)]
        self._err = None
        self._busy = 0.0           # seconds inside finished jobs, all lanes
        self._since = [None] * n   # perf_counter at each lane's running job's start
        self._pending = {}         # key -> [lane, jobs of the key not yet finished]
        self._backlog = 0          # jobs submitted and not yet finished
        self._next = 0             # the lane of the next new key
        self._lock = threading.Lock()
        for lane in range(n):
            threading.Thread(target=self._run, args=(lane,), daemon=True).start()

    def _run(self, lane):
        q = self._queues[lane]
        while True:
            fn, args, kwargs, key = q.get()
            with self._lock:
                self._since[lane] = time.perf_counter()
            try:
                fn(*args, **kwargs)
            except Exception as e:  # surfaced at the next flush()
                with self._lock:
                    if self._err is None:
                        self._err = e
            finally:
                with self._lock:
                    self._busy += time.perf_counter() - self._since[lane]
                    self._since[lane] = None
                    self._backlog -= 1
                    if key is not None:
                        entry = self._pending[key]
                        entry[1] -= 1
                        if entry[1] == 0:
                            del self._pending[key]
                q.task_done()

    @property
    def busy_s(self) -> float:
        """Seconds the lanes have spent inside jobs, summed over lanes, the
        running ones' so far included."""
        with self._lock:
            now = time.perf_counter()
            return self._busy + sum(now - s for s in self._since if s is not None)

    @property
    def backlog(self) -> int:
        """Jobs submitted and not yet finished, over all lanes."""
        with self._lock:
            return self._backlog

    def submit(self, fn, *args, **kwargs):
        """Enqueue fn(*args, **kwargs) behind every unkeyed job submitted
        before it. Arguments must not be mutated by the caller afterwards
        (pass copies of any mutable host buffers)."""
        with self._lock:
            self._backlog += 1
        self._queues[0].put((fn, args, kwargs, None))

    def submit_keyed(self, key, fn, *args, **kwargs):
        """Enqueue fn(*args, **kwargs) behind every job submitted before it
        under the same `key` (the file it writes); jobs of other keys may
        run beside it. Arguments as for ``submit``."""
        with self._lock:
            self._backlog += 1
            entry = self._pending.get(key)
            if entry is None:
                entry = self._pending[key] = [self._next % len(self._queues), 0]
                self._next += 1
            entry[1] += 1
            lane = entry[0]
        self._queues[lane].put((fn, args, kwargs, key))

    def flush(self):
        """Block until every submitted write has completed, on every lane;
        re-raise the first error seen since the previous flush."""
        for q in self._queues:
            q.join()
        with self._lock:
            err, self._err = self._err, None
        if err is not None:
            raise err


_writer = None
_lock = threading.Lock()


def get_writer() -> BackgroundWriter:
    global _writer
    with _lock:
        if _writer is None:
            _writer = BackgroundWriter()
            # the lanes are daemon threads — drain them at interpreter exit
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


def writer_backlog() -> int:
    """The global writer's ``backlog``; 0 if none was ever created."""
    return _writer.backlog if _writer is not None else 0
