"""Host-side pools for black-box likelihood fan-out.

Counterpart of ``pocomc_tpu/parallel/pool.py``, copied because importing
it from ``pocomc_tpu`` would import JAX. ``MPIPool`` is a master-worker
MPI task farm with the surface of the original pocoMC's (adapted there
from schwimmbad): workers enter a wait() loop at construction and exit at
close(); the master's map() hands one task per free worker with tag =
task index and reassembles results in order. mpi4py is imported lazily
(an optional dependency).
"""

from __future__ import annotations

import atexit
import sys


class MPIPool:
    """Master-worker MPI pool exposing map() / close() / context manager."""

    def __init__(self, comm=None, use_dill: bool = False):
        try:
            from mpi4py import MPI
        except ImportError as e:  # pragma: no cover - env without mpi4py
            raise ImportError(
                "mpi4py is required for MPIPool; install it or use "
                "pool=<int> / a multiprocessing pool instead.") from e
        self.MPI = MPI
        if use_dill:
            try:
                import dill
                MPI.pickle.__init__(dill.dumps, dill.loads)
            except ImportError:
                pass
        self.comm = MPI.COMM_WORLD if comm is None else comm
        self.master = 0
        self.rank = self.comm.Get_rank()
        self.size = self.comm.Get_size() - 1
        if self.size == 0:
            raise ValueError("MPIPool needs at least 2 MPI processes.")
        if not self.is_master():
            self.wait()
            sys.exit(0)
        self.workers = set(range(self.comm.size)) - {self.master}
        self._closed = False
        # Safety net matching the reference (parallel.py:54): a master
        # that exits without close() would otherwise leave every worker
        # blocked in recv() forever.
        atexit.register(self.close)

    def is_master(self):
        return self.rank == self.master

    def is_worker(self):
        return self.rank != self.master

    def wait(self):
        """Worker loop: receive (func, arg) tasks until a poison pill."""
        status = self.MPI.Status()
        while True:
            task = self.comm.recv(source=self.master,
                                  tag=self.MPI.ANY_TAG, status=status)
            if task is None:
                break
            func, arg = task
            result = func(arg)
            self.comm.ssend(result, self.master, status.tag)

    def map(self, func, iterable):
        """Distribute tasks over workers; results returned in order."""
        if not self.is_master():
            self.wait()
            sys.exit(0)

        tasks = [(i, (func, arg)) for i, arg in enumerate(iterable)]
        results = [None] * len(tasks)
        pending = len(tasks)
        workerset = self.workers.copy()
        tasklist = list(reversed(tasks))
        status = self.MPI.Status()

        while pending > 0:
            # hand one task to every free worker, then BLOCK for the
            # next result — no Iprobe busy-wait while all workers are
            # busy (the reference blocks in Probe there, parallel.py:139)
            while workerset and tasklist:
                worker = workerset.pop()
                taskid, task = tasklist.pop()
                self.comm.send(task, dest=worker, tag=taskid)

            result = self.comm.recv(source=self.MPI.ANY_SOURCE,
                                    tag=self.MPI.ANY_TAG, status=status)
            worker = status.source
            taskid = status.tag
            workerset.add(worker)
            results[taskid] = result
            pending -= 1

        return results

    def close(self):
        """Send poison pills once; idempotent (also runs via atexit)."""
        if not self.is_master() or self._closed:
            return
        self._closed = True
        atexit.unregister(self.close)
        for worker in self.workers:
            self.comm.send(None, dest=worker, tag=0)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()
