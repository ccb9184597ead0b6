"""The worker pool behind the host BFS's ``threads(n)``.

The port's copy of ``stateright_tpu/checker/_market.py``, after the
reference's ``JobMarket`` (a mutex, a condition variable and a list of
jobs): a worker takes a job (a block of pending states), runs a bounded
``check_block`` on it, then splits its surplus into shares for the
workers that wait. The termination and early-exit rules are the
reference's, so counts and discoveries equal the JAX package's.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

__all__ = ["JobMarket", "SharedCount", "run_worker_loop"]

CHECK_BLOCK_SIZE = 1500  # states per check_block call (bfs.rs:120)


class SharedCount:
    """Thread-safe counter (the reference's ``AtomicUsize``). Engines
    accumulate locally inside ``check_block`` and flush once per block, so
    the lock is uncontended in practice."""

    __slots__ = ("value", "_lock")

    def __init__(self, value: int = 0):
        self.value = value
        self._lock = threading.Lock()

    def add(self, n: int) -> None:
        if n:
            with self._lock:
                self.value += n


class JobMarket:
    """Shared queue of jobs guarded by a lock + condition.

    ``dead_count`` tracks workers that exited on ``target_state_count``
    without marking themselves waiting (the reference leaves ``is_done``
    false in that case, `bfs.rs:129-134` — but unlike the reference, a
    still-parked waiter here is released once everyone else is waiting or
    dead, so ``join()`` cannot hang)."""

    def __init__(self, thread_count: int, initial_job):
        self.lock = threading.Lock()
        self.has_new_job = threading.Condition(self.lock)
        self.wait_count = thread_count
        self.dead_count = 0
        self.jobs: List = [initial_job]
        #: worker exceptions, re-raised by ``Checker.join()`` — a worker
        #: that dies must not let the run report partial results as if
        #: checking completed.
        self.errors: List[BaseException] = []


def run_worker_loop(
    market: JobMarket,
    thread_count: int,
    check_block: Callable,
    discoveries: dict,
    property_count: int,
    target_state_count: Optional[int],
    state_count: "SharedCount",
    empty_job: Callable,
    job_len: Callable,
    split_off: Callable,
) -> None:
    """One worker's loop (`bfs.rs:83-152`). ``check_block(pending)`` mutates
    the job in place; ``split_off(pending, size)`` removes and returns the
    ``size`` elements that would be processed soonest."""
    try:
        _worker_loop(market, thread_count, check_block, discoveries,
                     property_count, target_state_count, state_count,
                     empty_job, job_len, split_off)
    except BaseException as e:  # noqa: BLE001 — surfaced at join()
        with market.lock:
            market.errors.append(e)
            market.dead_count += 1
            market.has_new_job.notify_all()


def _worker_loop(
    market: JobMarket,
    thread_count: int,
    check_block: Callable,
    discoveries: dict,
    property_count: int,
    target_state_count: Optional[int],
    state_count: "SharedCount",
    empty_job: Callable,
    job_len: Callable,
    split_off: Callable,
) -> None:
    pending = empty_job()
    while True:
        # Step 1: Do work.
        if job_len(pending) == 0:
            with market.lock:
                while True:
                    if market.jobs:
                        pending = market.jobs.pop()
                        market.wait_count -= 1
                        break
                    # Done if all peers are waiting or dead.
                    if market.wait_count + market.dead_count >= thread_count:
                        market.has_new_job.notify_all()
                        return
                    market.has_new_job.wait()
        check_block(pending, CHECK_BLOCK_SIZE)
        if len(discoveries) == property_count:
            with market.lock:
                market.wait_count += 1
                market.has_new_job.notify_all()
            return
        if target_state_count is not None and target_state_count <= state_count.value:
            # Deliberately does NOT increment wait_count, matching the
            # reference (`bfs.rs:129-134`): is_done() stays false because
            # checking is incomplete. dead_count releases parked waiters.
            with market.lock:
                market.dead_count += 1
                market.has_new_job.notify_all()
            return

        # Step 2: Share work.
        if job_len(pending) > 1 and thread_count > 1:
            with market.lock:
                pieces = 1 + min(market.wait_count, job_len(pending))
                size = job_len(pending) // pieces
                for _ in range(1, pieces):
                    market.jobs.append(split_off(pending, size))
                    market.has_new_job.notify()
        elif job_len(pending) == 0:
            with market.lock:
                market.wait_count += 1
