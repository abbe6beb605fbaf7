"""The run's threads on the host, and what they did in the window.

The program launches from Python: the main thread's pace is the rate in
every cell where the device waits on the host. ``limit_threads`` (before
``torch`` is imported) gives the CPU's parallel regions (OpenMP, MKL,
OpenBLAS) one thread: the program's host work is serial Python and small
tensors, and a pool of workers that spin after each parallel region burns
cores for nothing.

``threads`` reads, from ``/proc``, each thread's name, core, CPU time and
involuntary context switches, and ``delta`` prints the window's share of
them: the CPU seconds that a step's fixed work took show the host's speed.
"""

from __future__ import annotations

import os

THREAD_ENV = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def limit_threads(n: int = 1) -> None:
    for k in THREAD_ENV:
        os.environ[k] = str(n)


def _tids() -> list:
    try:
        return sorted(int(t) for t in os.listdir("/proc/self/task"))
    except OSError:
        return []


def threads() -> list:
    """``(name, core, cpu seconds, involuntary switches)`` of each thread."""
    tick = os.sysconf("SC_CLK_TCK")
    out = []
    for tid in _tids():
        base = f"/proc/self/task/{tid}"
        try:
            with open(f"{base}/stat") as f:
                stat = f.read()
            with open(f"{base}/status") as f:
                status = f.read()
        except OSError:
            continue
        name = stat[stat.index("(") + 1:stat.rindex(")")]
        fields = stat[stat.rindex(")") + 2:].split()
        cpu_s = (int(fields[11]) + int(fields[12])) / tick
        nvcsw = next((int(line.split()[1]) for line in status.splitlines()
                      if line.startswith("nonvoluntary_ctxt_switches")), 0)
        out.append((name, int(fields[36]), cpu_s, nvcsw))
    return out


def delta(before: list, after: list) -> str:
    """The window's CPU seconds and involuntary switches by thread name."""
    acc = {}
    for sign, rows in ((-1, before), (1, after)):
        for name, _, cpu_s, nv in rows:
            c, n = acc.get(name, (0.0, 0))
            acc[name] = (c + sign * cpu_s, n + sign * nv)
    busy = sorted(acc.items(), key=lambda kv: -kv[1][0])[:6]
    return ", ".join(f"{n} {c:.2f} s/{v} inv" for n, (c, v) in busy)
