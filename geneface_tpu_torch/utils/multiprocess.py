"""Worker-pool map with ordered (or as-ready) result yield (a copy of
``geneface_tpu/utils/multiprocess.py``).

Counterpart of ``utils/commons/multiprocess_utils.py`` (``chunked_worker:7``,
``MultiprocessManager:28``, ``multiprocess_run:93``): a job-queue pool used by
the CPU-bound preprocessing layer (frame extraction, parsing, feature dumps).
Supports process or thread backends and an optional per-worker init context.
"""

from __future__ import annotations

import os
import traceback
from functools import partial
from typing import Any, Callable, Iterable, Iterator

__all__ = ["MultiprocessManager", "multiprocess_run", "multiprocess_run_tqdm"]

_KILL = "<KILL>"


def _worker(worker_id, args_queue, results_queue, init_ctx_func):
    ctx = init_ctx_func(worker_id) if init_ctx_func is not None else None
    while True:
        job = args_queue.get()
        if job == _KILL:
            return
        job_idx, fn, arg = job
        try:
            fn_ = partial(fn, ctx=ctx) if ctx is not None else fn
            if isinstance(arg, dict):
                res = fn_(**arg)
            elif isinstance(arg, (list, tuple)):
                res = fn_(*arg)
            else:
                res = fn_(arg)
            results_queue.put((job_idx, res))
        except Exception:
            traceback.print_exc()
            results_queue.put((job_idx, None))


class MultiprocessManager:
    """Submit jobs with :meth:`add_job`, then iterate :meth:`get_results`
    (as-completed order, tagged with the job index)."""

    def __init__(
        self,
        num_workers: int | None = None,
        init_ctx_func: Callable[[int], Any] | None = None,
        multithread: bool = False,
    ):
        if multithread:
            from multiprocessing.dummy import Process, Queue
        else:
            from multiprocessing import Process, Queue
        if num_workers is None:
            num_workers = int(os.getenv("N_PROC", os.cpu_count() or 1))
        self.num_workers = num_workers
        self.results_queue = Queue()
        self.args_queue = Queue()
        self.total_jobs = 0
        self.workers = []
        for i in range(num_workers):
            p = Process(
                target=_worker,
                args=(i, self.args_queue, self.results_queue, init_ctx_func),
            )
            if not multithread:
                p.daemon = True
            p.start()
            self.workers.append(p)

    def add_job(self, fn: Callable, args: Any) -> None:
        self.args_queue.put((self.total_jobs, fn, args))
        self.total_jobs += 1

    def get_results(self) -> Iterator[tuple[int, Any]]:
        for _ in range(self.total_jobs):
            yield self.results_queue.get()
        self.close()

    def close(self) -> None:
        for _ in self.workers:
            self.args_queue.put(_KILL)
        for w in self.workers:
            w.join()

    def __len__(self) -> int:
        return self.total_jobs


def multiprocess_run(
    fn: Callable,
    args: Iterable[Any],
    num_workers: int | None = None,
    ordered: bool = True,
    init_ctx_func: Callable[[int], Any] | None = None,
    multithread: bool = False,
) -> Iterator[tuple[int, Any]]:
    """Map ``fn`` over ``args`` on a pool, yielding ``(job_idx, result)``.

    ``ordered=True`` buffers out-of-order completions so results arrive in
    submission order (``multiprocess_utils.py:93-130``).
    """
    args = list(args)
    mgr = MultiprocessManager(
        num_workers=num_workers, init_ctx_func=init_ctx_func,
        multithread=multithread,
    )
    for a in args:
        mgr.add_job(fn, a)
    if not ordered:
        yield from mgr.get_results()
        return
    buf: dict[int, Any] = {}
    next_idx = 0
    for idx, res in mgr.get_results():
        buf[idx] = res
        while next_idx in buf:
            yield next_idx, buf.pop(next_idx)
            next_idx += 1


def multiprocess_run_tqdm(fn, args, num_workers=None, desc=None, **kw):
    """Progress-bar variant (capability of the reference's tqdm wrapper)."""
    try:
        from tqdm import tqdm

        yield from tqdm(
            multiprocess_run(fn, args, num_workers=num_workers, **kw),
            total=len(list(args)) if not hasattr(args, "__len__") else len(args),
            desc=desc,
        )
    except ImportError:  # pragma: no cover
        yield from multiprocess_run(fn, args, num_workers=num_workers, **kw)
