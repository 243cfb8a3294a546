"""Profiling helpers: host wall timing that waits for the card, and
``torch.profiler`` traces.

Port of the JAX package's ``utils/profiling.py``, with the same names and
return shapes.  A call's outputs are fenced by synchronizing the CUDA
device of every tensor in them (tuples, lists, dicts and ``RecordBatch``
walked), where JAX blocks until they are ready.  There is no ``jit``: the
first call of a function builds and loads the kernels it launches, and
``timed_steady`` reports that call's time where JAX reports the compile.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


def _tensors(out):
    """Every tensor of `out`, depth first."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _tensors(getattr(out, f.name))


def _synchronize(out) -> None:
    """Wait for every CUDA device that holds a tensor of `out`."""
    for dev in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def timed(fn, *args, reps: int = 3, warmup: int = 1):
    """(best_seconds, last_output): the least host wall of `reps` calls,
    each ended by synchronizing the devices of its outputs."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        _synchronize(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _synchronize(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def fence(out) -> float:
    """Read one scalar of the first tensor of `out` back to the host, which
    cannot finish before the work that made it."""
    leaf = next(_tensors(out))
    return float(leaf.reshape(-1)[0].item())


def timed_steady(fn, args, k: int = 6, reps: int = 2):
    """(per_iter_seconds, first_call_seconds): the steady state of k calls
    issued back to back.

    k calls are issued and only the last output fenced, then a single call
    is subtracted, which cancels the fixed cost of one round trip to the
    host.  The minima of the single-call and the k-call times are taken
    independently before the subtraction: a best-of over per-rep
    differences is biased low where the noise is one-sided.  The second
    value is the first call's time, which includes building and loading
    the kernels it launches."""
    t0 = time.perf_counter()
    fence(fn(*args))
    first_s = time.perf_counter() - t0
    t1s, tks = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fence(fn(*args))
        t1s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out = None
        for _ in range(k):
            out = fn(*args)
        fence(out)
        tks.append(time.perf_counter() - t0)
    per = max((min(tks) - min(t1s)) / (k - 1), 1e-9)
    return per, first_s


@contextlib.contextmanager
def trace(logdir: str | None):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    `logdir`, as a Chrome trace file (a no-op if logdir is None).  It holds
    the host's operators and, where a card ran, every kernel the block
    launched."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """A named span in profiler timelines: a ``record_function`` range, and
    an NVTX range where a card is initialized."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
