"""Host work on a bounded window of threads.

Drawing a full-width model's weights and compressing, hashing or
decompressing its checkpoint are gigabytes of host work, done leaf by leaf
by calls that let go of the GIL (a seeded ``torch.randn``, zlib, sha256).
``imap_window`` runs such calls on every core while the host holds only a
window of leaves in flight, not the whole tree.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

WORKERS = min(8, os.cpu_count() or 1)


def imap_window(fn: Callable, args: Iterable[tuple], cost: Callable[[tuple], int],
                budget: int) -> Iterator:
    """``(fn(*a) for a in args)`` with each call on a pool of WORKERS
    threads, yielded in order. A call is submitted only while the calls
    submitted and not yet taken cost at most ``budget`` together with it
    (``cost(a)``, bytes say); when the window is empty one is submitted
    whatever it costs. ``args`` is drawn on the calling thread, one at a
    time as the window has room."""
    with ThreadPoolExecutor(max_workers=WORKERS) as pool:
        window: deque = deque()
        held = 0
        for a in args:
            c = cost(a)
            while window and held + c > budget:
                future, taken = window.popleft()
                held -= taken
                yield future.result()
            window.append((pool.submit(fn, *a), c))
            held += c
        while window:
            yield window.popleft()[0].result()
