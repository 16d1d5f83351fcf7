"""AsyncSolverServer: event-loop continuous batching over SolverService.

Adapted from ``src/repro/serve/async_server.py``.
``SolverService`` is a synchronous window: callers submit, someone calls
``flush()``, everyone waits.  A production mix of millions of small
requests needs the serving loop itself to decide *when* to dispatch —
trading batch fullness (throughput) against the oldest request's latency
budget — while refusing work it cannot absorb.  This module is that loop:

    submit(a, b, deadline_ms=…)        [asyncio coroutine → Future]
        │ admission: typed validation (InvalidRequestError taxonomy)
        │ backpressure: bounded per-group queue + global bound
        │   → full ⇒ immediate typed result (status="rejected",
        │     error.code="queue_full"); never an unbounded pileup
        ▼
    per-(fingerprint, RHS-shape) deques          ◄── flusher task wakes on:
        │                                            · a group reached
        ▼                                              batch_size
    dispatch thread (single worker)                  · the oldest request's
        service.solve_batch(window)                    deadline is within
        │  (validation, isolation, escalation          deadline_margin_ms
        ▼   ladder — see solver_service)             · max_linger_ms elapsed
    futures resolve with terminal SolveResult          since the oldest
    (latency_s + deadline_missed filled in)            request arrived

Design notes:

* **One dispatch worker.**  A dispatch blocks its thread (the batched
  path waits on the card for pivots and residuals), so dispatches run on a
  single ``ThreadPoolExecutor`` worker: the event loop stays free to admit
  and reject while a batch computes, and every CUDA launch comes from that
  one thread, one stream of launches as in the reference.
* **Deadlines are soft.**  A request whose budget expires in the queue is
  *not* dropped — it dispatches in the next window and its result carries
  ``deadline_missed=True`` (and the miss is counted).  Dropping late work
  would violate the exactly-one-terminal-result contract.
* **Groups flush whole windows.**  When any trigger fires, every
  non-empty group queue is drained into one ``solve_batch`` call —
  ``SolverService`` re-groups by fingerprint internally, so cross-pattern
  batching costs nothing and the oldest request is always in the window
  that its trigger fired for.
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core.options import plan_fingerprint
from .solver_service import (ERR_DISPATCH, ERR_QUEUE_FULL,
                             STATUS_FAILED, STATUS_REJECTED,
                             InvalidRequestError, SolveError, SolveRequest,
                             SolveResult, SolverService, validate_request)


class _Pending:
    """One admitted request waiting in a group queue."""

    __slots__ = ("req", "future", "t_submit", "t_deadline")

    def __init__(self, req, future, t_submit, t_deadline):
        self.req = req
        self.future = future
        self.t_submit = t_submit      # monotonic seconds at admission
        self.t_deadline = t_deadline  # absolute monotonic deadline (or None)


class AsyncSolverServer:
    """Continuous-batching asyncio front-end for a :class:`SolverService`.

    service            — the synchronous SolverService to dispatch through
                         (default ``SolverService()``: on the card, so
                         without one this raises)
    max_queue_per_group — bounded depth of each (pattern, RHS-shape) queue;
                         admission control rejects (typed ``queue_full``)
                         beyond it
    max_pending        — global bound across all groups (second backpressure
                         tier, so many small groups cannot pile up
                         unboundedly either)
    deadline_margin_ms — flush a group when its oldest request's deadline is
                         within this margin (covers dispatch latency)
    max_linger_ms      — flush a non-empty window at most this long after
                         its oldest request arrived, even with no deadline
                         pressure (bounds latency for deadline-less traffic)
    default_deadline_ms — per-request latency budget applied when a submit
                         does not pass one (None = no deadline; falls back
                         to ``service.opts.deadline_ms``)

    Lifecycle: ``await server.start()`` … ``await server.stop()`` (drains by
    default), or ``async with AsyncSolverServer(...) as server:``.
    """

    def __init__(self, service: SolverService | None = None,
                 max_queue_per_group: int = 64,
                 max_pending: int = 256,
                 deadline_margin_ms: float = 5.0,
                 max_linger_ms: float = 50.0,
                 default_deadline_ms: float | None = None):
        self.service = service or SolverService()
        if max_queue_per_group < 1:
            raise ValueError(f"max_queue_per_group must be >= 1, got "
                             f"{max_queue_per_group}")
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_queue_per_group = max_queue_per_group
        self.max_pending = max_pending
        self.deadline_margin_s = deadline_margin_ms / 1e3
        self.max_linger_s = max_linger_ms / 1e3
        if default_deadline_ms is None:
            default_deadline_ms = self.service.opts.deadline_ms
        self.default_deadline_ms = default_deadline_ms

        self._queues: dict[tuple, deque] = {}   # (fingerprint, tail) → deque
        self._n_pending = 0
        self._wake = None           # asyncio.Event, created in start()
        self._flusher = None        # the flusher task
        self._executor = None       # single-worker dispatch executor
        self._running = False
        self._latencies_ms: deque = deque(maxlen=4096)  # completed requests
        self.counters = dict(submitted=0, completed=0, rejected_full=0,
                             rejected_invalid=0, deadline_misses=0,
                             dispatch_batches=0)

    # ------------------------------------------------------------ lifecycle
    async def start(self):
        if self._running:
            return self
        self._running = True
        self._wake = asyncio.Event()
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="hylu-dispatch")
        self._flusher = asyncio.create_task(self._flush_loop())
        return self

    async def stop(self, drain: bool = True):
        """Stop the server.  With ``drain`` (default), every queued request
        is dispatched first — nothing admitted is ever lost; without it,
        queued requests resolve as rejected (``queue_full`` taxonomy code
        with ``detail["stage"]="shutdown"``)."""
        if not self._running:
            return
        if drain:
            while self._n_pending:
                await self._dispatch_window(self._drain_all())
        self._running = False
        self._wake.set()
        if self._flusher is not None:
            await self._flusher
            self._flusher = None
        if not drain:
            for p in self._drain_all():
                self._resolve(p, SolveResult(
                    status=STATUS_REJECTED, tag=p.req.tag,
                    error=SolveError(ERR_QUEUE_FULL,
                                     "server stopped without draining",
                                     dict(stage="shutdown"))))
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    async def __aenter__(self):
        return await self.start()

    async def __aexit__(self, *exc):
        await self.stop(drain=True)

    # ------------------------------------------------------------ admission
    async def submit(self, a, b, tag=None, factor_dtype=None,
                     deadline_ms: float | None = None) -> asyncio.Future:
        """Validate and enqueue one request; returns an ``asyncio.Future``
        resolving to this request's terminal :class:`SolveResult`.

        Raises :class:`InvalidRequestError` for an inadmissible request
        (malformed work is refused at the door, same contract as
        ``SolverService.submit``).  A full queue does NOT raise — the
        returned future resolves immediately with a typed
        ``status="rejected"`` / ``error.code="queue_full"`` result, so the
        caller always holds exactly one future per request and backpressure
        is data, not control flow."""
        if not self._running:
            raise RuntimeError("AsyncSolverServer is not running — use "
                               "'await server.start()' or 'async with'")
        a, b, err = validate_request(a, b)
        if err is not None:
            self.counters["rejected_invalid"] += 1
            raise InvalidRequestError(err)
        req = SolveRequest(a=a, b=b, tag=tag, factor_dtype=factor_dtype)

        loop = asyncio.get_running_loop()
        future = loop.create_future()
        key = self._group_key(req)
        q = self._queues.setdefault(key, deque())
        if len(q) >= self.max_queue_per_group or \
                self._n_pending >= self.max_pending:
            scope = ("group" if len(q) >= self.max_queue_per_group
                     else "global")
            self.counters["rejected_full"] += 1
            future.set_result(SolveResult(
                status=STATUS_REJECTED, tag=tag,
                error=SolveError(
                    ERR_QUEUE_FULL,
                    f"{scope} queue full "
                    f"(group depth {len(q)}/{self.max_queue_per_group}, "
                    f"pending {self._n_pending}/{self.max_pending})",
                    dict(scope=scope, group_depth=len(q),
                         max_queue_per_group=self.max_queue_per_group,
                         pending=self._n_pending,
                         max_pending=self.max_pending))))
            return future

        now = time.monotonic()
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        t_deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        q.append(_Pending(req, future, now, t_deadline))
        self._n_pending += 1
        self.counters["submitted"] += 1
        self._wake.set()
        return future

    async def solve(self, a, b, tag=None, factor_dtype=None,
                    deadline_ms: float | None = None) -> SolveResult:
        """Submit one request and await its terminal result."""
        fut = await self.submit(a, b, tag=tag, factor_dtype=factor_dtype,
                                deadline_ms=deadline_ms)
        return await fut

    def _group_key(self, req: SolveRequest) -> tuple:
        opts = self.service._opts_for(req)
        return (plan_fingerprint(req.a, opts), req.b.shape[1:])

    # ---------------------------------------------------------- flush logic
    def _next_wakeup(self, now: float):
        """(flush_now, sleep_s): whether any trigger has fired, and how long
        the flusher may sleep before the earliest future trigger."""
        flush = False
        sleep_s = None
        bs = self.service.batch_size
        for q in self._queues.values():
            if not q:
                continue
            if bs is not None and len(q) >= bs:
                flush = True
                break
            head = q[0]
            triggers = [head.t_submit + self.max_linger_s]
            if head.t_deadline is not None:
                triggers.append(head.t_deadline - self.deadline_margin_s)
            t_fire = min(triggers)
            if t_fire <= now:
                flush = True
                break
            dt = t_fire - now
            sleep_s = dt if sleep_s is None else min(sleep_s, dt)
        return flush, sleep_s

    def _drain_all(self) -> list:
        window = []
        for q in self._queues.values():
            window.extend(q)
            q.clear()
        self._n_pending = 0
        return window

    async def _flush_loop(self):
        while self._running:
            flush, sleep_s = self._next_wakeup(time.monotonic())
            if flush:
                await self._dispatch_window(self._drain_all())
                continue
            self._wake.clear()
            # re-check after clearing: a submit may have raced the clear
            flush, sleep_s = self._next_wakeup(time.monotonic())
            if flush:
                continue
            try:
                await asyncio.wait_for(self._wake.wait(), timeout=sleep_s)
            except asyncio.TimeoutError:
                pass

    async def _dispatch_window(self, window: list):
        if not window:
            return
        loop = asyncio.get_running_loop()
        reqs = [p.req for p in window]
        self.counters["dispatch_batches"] += 1
        try:
            results = await loop.run_in_executor(
                self._executor, self.service.solve_batch, reqs)
        except BaseException as e:  # never lose a window; see below
            for p in window:
                self._resolve(p, SolveResult(
                    status=STATUS_FAILED, tag=p.req.tag,
                    error=SolveError(ERR_DISPATCH,
                                     f"window dispatch raised "
                                     f"{type(e).__name__}: {e}",
                                     dict(stage="window"))))
            if not isinstance(e, Exception):
                raise                   # cancellation and exit propagate
            return
        for p, r in zip(window, results):
            self._resolve(p, r)

    def _resolve(self, p: _Pending, result: SolveResult):
        now = time.monotonic()
        result.latency_s = now - p.t_submit
        if p.t_deadline is not None and now > p.t_deadline:
            result.deadline_missed = True
            self.counters["deadline_misses"] += 1
        self.counters["completed"] += 1
        if result.status != STATUS_REJECTED:
            # admission rejections are instant — keeping them out of the
            # latency record stops rejects from faking a fast p50
            self._latencies_ms.append(result.latency_s * 1e3)
        if not p.future.done():
            p.future.get_loop().call_soon_threadsafe(
                _set_result_safe, p.future, result)

    # ------------------------------------------------------------ telemetry
    def stats(self) -> dict:
        """Structured serving stats: queue depth, latency percentiles,
        deadline-miss / reject rates, and the underlying service's
        dispatch counters."""
        lat = np.asarray(self._latencies_ms, dtype=np.float64)
        completed = max(1, self.counters["completed"])
        return dict(
            queue_depth=self._n_pending,
            n_groups=sum(1 for q in self._queues.values() if q),
            submitted=self.counters["submitted"],
            completed=self.counters["completed"],
            dispatch_batches=self.counters["dispatch_batches"],
            p50_ms=float(np.percentile(lat, 50)) if lat.size else None,
            p99_ms=float(np.percentile(lat, 99)) if lat.size else None,
            deadline_miss_rate=self.counters["deadline_misses"] / completed,
            reject_rate=(self.counters["rejected_full"]
                         + self.counters["rejected_invalid"])
                        / max(1, self.counters["submitted"]
                              + self.counters["rejected_full"]
                              + self.counters["rejected_invalid"]),
            rejected_full=self.counters["rejected_full"],
            rejected_invalid=self.counters["rejected_invalid"],
            deadline_misses=self.counters["deadline_misses"],
            retries=self.service.stats["retries"],
            quarantined=self.service.stats["quarantined"],
            failed=self.service.stats["failed"],
            service=dict(self.service.stats),
        )


def _set_result_safe(future, result):
    if not future.done():
        future.set_result(result)
