"""Concurrent request intake: bounded queue, coalescing, admission.

Counterpart of ``repro.serve.frontend``.  Concurrent clients and the
single-writer engine meet here.  The ``Frontend`` owns a bounded queue and
ONE worker thread; clients call ``submit()`` (any thread) and get a
``concurrent.futures.Future``; ``submit()`` only enqueues, and the worker
drains the queue and is the only thread that builds problems or touches
the ``Router``'s Sessions, so all CUDA work runs on it and concurrent
submissions give artifacts bit-identical to serial runs.

  * **Admission control.**  The worker resolves each decompose request's
    problem and computes the *padded* plan bytes, ``4 * e_pad * C`` with
    ``e_pad = bucket_size(n_s * C, PLAN_EDGE_FLOOR)``: the Session's gate
    and the reference's formula.  An over-budget graph is rejected before
    its decompose: its future raises a typed ``AdmissionError`` (the
    reference raises it from ``submit()``, which builds the problem on the
    client's thread).  A full queue is a typed ``QueueFullError`` from
    ``submit()``.
  * **Coalescing.**  The worker drains whatever is queued, groups decompose
    jobs by (pool, shape bucket) and runs each group through
    ``Session.decompose_many``.  Updates keep FIFO order.
  * **Queries stay off the queue.**  ``query()`` reads the named
    artifact's cached cut/nuclei tables directly (host numpy).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

from ..core.engine import MEGAKERNEL_PLAN_BUDGET_BYTES
from ..core.incidence import NucleusProblem
from ..core.session import padded_plan_edges
from ..device import DeviceLike
from .router import Request, Router, pool_key


class AdmissionError(RuntimeError):
    """Request rejected up front: the padded engine plan for this graph
    would exceed the server's admission budget."""

    def __init__(self, plan_bytes: int, budget_bytes: int):
        self.plan_bytes = int(plan_bytes)
        self.budget_bytes = int(budget_bytes)
        super().__init__(
            f"admission rejected: padded plan needs {self.plan_bytes} "
            f"bytes > budget {self.budget_bytes} bytes — decompose this "
            f"graph offline (chunked build) and serve the artifact, or "
            f"raise admission_budget_bytes")


class QueueFullError(RuntimeError):
    """Request rejected: the bounded intake queue is full (backpressure:
    retry after the pool drains)."""


def padded_plan_bytes(problem: NucleusProblem) -> int:
    """What the bucketed engine's megakernel plan takes for ``problem``:
    the (e_pad, C) int32 member matrix with the edge axis pow2-bucketed,
    the Session's gate reused as the admission formula."""
    return 4 * padded_plan_edges(problem) * problem.n_sub


@dataclasses.dataclass
class _Job:
    request: Request
    future: Future


class Frontend:
    """The server's intake: ``submit() -> Future`` plus a worker loop.

    ``max_queue`` bounds in-flight work; ``admission_budget_bytes``
    defaults to the engine's megakernel plan budget.  ``start()``/``stop()``
    manage the worker thread; ``stop()`` cancels whatever is still queued.
    Without a ``router`` one is made on ``device`` (``None``: the card).
    """

    def __init__(self, router: Optional[Router] = None, *,
                 max_queue: int = 64,
                 admission_budget_bytes: int = MEGAKERNEL_PLAN_BUDGET_BYTES,
                 batch_wait_s: float = 0.002, device: DeviceLike = None):
        self.router = router if router is not None else Router(device=device)
        self.admission_budget_bytes = int(admission_budget_bytes)
        self.batch_wait_s = float(batch_wait_s)
        self._queue: "queue.Queue[_Job]" = queue.Queue(maxsize=max_queue)
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "submitted": 0,           # accepted into the queue
            "served": 0,              # futures resolved successfully
            "failed": 0,              # futures resolved with an exception
            "rejected_admission": 0,  # AdmissionError (worker, future)
            "rejected_queue": 0,      # QueueFullError at submit()
            "batches": 0,             # worker drain cycles that did work
            "coalesced": 0,           # decompose jobs served in a shared
                                      # decompose_many batch (size >= 2)
        }
        self._worker: Optional[threading.Thread] = None
        self._running = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Frontend":
        if self._worker is not None:
            return self
        self._running.set()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="nucleus-frontend")
        self._worker.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        if self._worker is None:
            return
        self._running.clear()
        self._worker.join(timeout)
        self._worker = None
        # cancel anything still queued: shutdown is explicit
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            job.future.cancel()

    @property
    def queue_depth(self) -> int:
        return self._queue.qsize()

    def _count(self, name: str, by: int = 1) -> None:
        with self._stats_lock:
            self.stats[name] += by

    # -- intake ------------------------------------------------------------
    def submit(self, request: Request) -> "Future":
        """Enqueue one request; returns a Future resolving to its
        ``Decomposition`` (or raising ``AdmissionError`` for an over-budget
        graph).  Raises ``QueueFullError`` (backpressure)."""
        if self._worker is None:
            raise RuntimeError("Frontend not started — call start() first")
        fut: Future = Future()
        try:
            self._queue.put_nowait(_Job(request=request, future=fut))
        except queue.Full:
            self._count("rejected_queue")
            raise QueueFullError(
                f"intake queue full ({self._queue.maxsize} jobs) — "
                f"retry after the pool drains") from None
        self._count("submitted")
        return fut

    def submit_wait(self, request: Request, timeout: float = 300.0):
        """``submit`` and block for the artifact."""
        return self.submit(request).result(timeout=timeout)

    # -- reads (never queued) ----------------------------------------------
    def query(self, name: str, kind: str, c: int):
        """Answer a cut/nuclei query from the named live artifact."""
        dec = self.router.artifact(name)
        if kind == "cut":
            return dec.cut(int(c))
        if kind == "nuclei":
            return dec.nuclei(int(c))
        raise ValueError(f"unknown query kind {kind!r}; expected "
                         f"'cut' or 'nuclei'")

    # -- the worker --------------------------------------------------------
    def _run(self) -> None:
        while self._running.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            # drain whatever arrived with it (plus a short window so a burst
            # of concurrent submits lands in one coalesced batch)
            waited = False
            while True:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    if waited or not self.batch_wait_s:
                        break
                    time.sleep(self.batch_wait_s)
                    waited = True
            self._serve_batch(batch)
            self._count("batches")

    def _admit(self, job: _Job) -> Optional[Tuple]:
        """Resolve a decompose job's problem and check its padded plan
        bytes; returns (problem, group key), or None when the job's future
        was resolved with the rejection."""
        try:
            problem, config = self.router.resolve(job.request)
        except Exception as e:
            job.future.set_exception(e)
            self._count("failed")
            return None
        need = padded_plan_bytes(problem)
        if need > self.admission_budget_bytes:
            job.future.set_exception(
                AdmissionError(need, self.admission_budget_bytes))
            self._count("rejected_admission")
            return None
        bucket = self.router.pool(config).bucket_key(problem, config)
        return problem, (pool_key(config), bucket)

    def _serve_batch(self, batch: List[_Job]) -> None:
        # decompose jobs grouped by (pool, shape bucket), each group one
        # decompose_many call; updates afterwards in FIFO order
        groups: Dict[Tuple, List[Tuple[_Job, NucleusProblem]]] = {}
        updates: List[_Job] = []
        for job in batch:
            if job.request.kind == "update":
                updates.append(job)
                continue
            admitted = self._admit(job)
            if admitted is not None:
                problem, key = admitted
                groups.setdefault(key, []).append((job, problem))
        for group in groups.values():
            jobs = [j for j, _ in group]
            try:
                decs = self.router.route_many(
                    [j.request for j in jobs],
                    problems=[p for _, p in group])
            except Exception as e:
                for j in jobs:
                    j.future.set_exception(e)
                self._count("failed", len(jobs))
                continue
            for j, dec in zip(jobs, decs):
                j.future.set_result(dec)
            self._count("served", len(jobs))
            if len(jobs) >= 2:
                self._count("coalesced", len(jobs))
        for job in updates:
            try:
                dec = self.router.update(job.request.artifact,
                                         job.request.update)
            except Exception as e:
                job.future.set_exception(e)
                self._count("failed")
                continue
            job.future.set_result(dec)
            self._count("served")
