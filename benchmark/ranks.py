"""Run a driver's rank function on several processes, one a card, joined
through the port's own entry (``parallel.multihost.initialize_distributed``),
and hand rank 0's result back to the caller.

    results = launch(driver_path, "rank_main", ranks=4, payload=...,
                     device="cuda", backend="nccl")

Each rank is a fresh ``spawn`` process. It holds itself to a core of its
own (rank 0 takes the caller's core, since the caller only waits), runs
PyTorch's host work on one thread, joins the process group at a free
port on 127.0.0.1, refuses any backend but ``backend``, loads the
driver by its path and calls ``fn(rank, ranks, payload, mark)``. What
``fn`` returns goes back over a pipe with the JAX modules the rank loaded
(``harness.forbidden_modules``). ``mark(name)`` tells the caller that the
rank is making progress: the launch allows ``stall_s`` seconds from the
start, and again from every mark, before it ends every rank.

A rank that raises, dies or stalls ends the launch: the others are
killed, and ``launch`` raises ``RankFailed``. A rank that loaded JAX or
the JAX package ends the run with exit code 3, as ``run.py`` does. No
rank outlives ``launch``.
"""
from __future__ import annotations

import os
import socket
import sys
import time
import traceback
from multiprocessing import get_context
from multiprocessing.connection import wait
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CPUSET = Path("/sys/fs/cgroup/cpuset.cpus.effective")
EXIT_S = 60.0      # a rank's time to leave its process group and exit


class RankFailed(RuntimeError):
    pass


def parse_cpuset(text: str) -> list[int]:
    """``0-3,8,10-11`` -> [0, 1, 2, 3, 8, 10, 11]."""
    cores: set[int] = set()
    for part in text.strip().split(","):
        if part:
            a, _, b = part.partition("-")
            cores.update(range(int(a), int(b or a) + 1))
    return sorted(cores)


def allowed_cores() -> list[int]:
    """The machine's cpuset, or every core where it states none."""
    return (parse_cpuset(CPUSET.read_text()) if CPUSET.is_file()
            else list(range(os.cpu_count() or 1)))


def rank_cores(ranks: int) -> list[int]:
    """A core for each rank: rank 0 the caller's (``run.py`` pins itself
    to one), the others the highest of the machine's cpuset apart from
    it, one each (shared round-robin where the cpuset has too few)."""
    allowed = allowed_cores()
    first = (max(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else allowed[-1])
    rest = [c for c in reversed(allowed) if c != first] or [first]
    return [first] + [rest[(r - 1) % len(rest)] for r in range(1, ranks)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank, ranks, port, path, fn, payload, conn, device, backend, core):
    """The body of one rank's process."""
    joined = False
    try:
        if hasattr(os, "sched_setaffinity"):
            os.sched_setaffinity(0, {core})
        if str(ROOT) not in sys.path:
            sys.path.insert(0, str(ROOT))
        import torch

        from benchmark import harness
        from das3r_tpu_torch.parallel import multihost
        torch.set_num_threads(1)
        got = multihost.initialize_distributed(
            coordinator_address=f"tcp://127.0.0.1:{port}",
            num_processes=ranks, process_id=rank, device=device)
        joined = True
        if got != backend:
            raise RuntimeError(f"rank {rank}: backend {got}, the cell "
                               f"needs {backend}")
        mod = harness.load_module(Path(path), f"bench_rank_{Path(path).stem}")
        out = getattr(mod, fn)(rank, ranks, payload,
                               lambda name: conn.send(("mark", name)))
        conn.send(("result", out, harness.forbidden_modules()))
    except BaseException:
        # the caller ends every rank; this one leaves its group as it is
        conn.send(("error", traceback.format_exc()))
        raise
    else:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()
    finally:
        conn.close()


def launch(path, fn: str, ranks: int, payload, device: str = "cuda",
           backend: str = "nccl", stall_s: float = 240.0) -> list:
    """Every rank's return value, in rank order (module docstring)."""
    ctx = get_context("spawn")
    port, cores = free_port(), rank_cores(ranks)
    procs, conns = [], []
    for r in range(ranks):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_rank, name=f"rank{r}", args=(
            r, ranks, port, str(path), fn, payload, send, device, backend,
            cores[r]))
        p.start()
        send.close()
        procs.append(p)
        conns.append(recv)
    results: dict[int, object] = {}
    forbidden: set[str] = set()
    try:
        deadline = time.monotonic() + stall_s
        live = dict(enumerate(conns))
        while live:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RankFailed(f"ranks {sorted(live)} made no progress "
                                 f"for {stall_s:.0f} s")
            for c in wait(list(live.values()), timeout=left):
                r = conns.index(c)
                try:
                    msg = c.recv()
                except EOFError:
                    procs[r].join(5)
                    raise RankFailed(f"rank {r} ended with exit code "
                                     f"{procs[r].exitcode} and no result")
                if msg[0] == "error":
                    raise RankFailed(f"rank {r} raised:\n{msg[1]}")
                deadline = time.monotonic() + stall_s
                if msg[0] == "result":
                    results[r] = msg[1]
                    forbidden.update(msg[2])
                    del live[r]
        # every result is in: a rank that then fails to leave its process
        # group is ended, and said so
        for p in procs:
            p.join(EXIT_S)
            if p.exitcode != 0:
                print(f"benchmark: {p.name} sent its result, then ended "
                      f"with exit code {p.exitcode}", file=sys.stderr)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
        for c in conns:
            c.close()
    if forbidden:
        print(f"benchmark: forbidden modules loaded by a rank: "
              f"{sorted(forbidden)}", file=sys.stderr)
        sys.exit(3)
    return [results[r] for r in range(ranks)]
