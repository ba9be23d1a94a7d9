"""Worker-thread shutdown registry.

Background workers (fused-step compiles, staged device fetches, async
precompute bakes) run XLA/C++ code on daemon threads.  A daemon thread
that is still inside native code when the interpreter finalizes gets
torn down via pthread_exit's forced unwind, which aborts the process
("terminate called after throwing an instance of ''" / "FATAL:
exception not rethrown") — the CLI hit this whenever a render finished
before its fused-step compile did.

The fix is the same pattern concurrent.futures uses: register a hook
with threading._register_atexit (it runs BEFORE non-daemon joins and
daemon teardown, while the interpreter is still fully functional) that
signals loop workers to stop and joins every live one-shot worker.
Objects owning loop workers register themselves with `track_closer`
and expose `close()`; one-shot worker threads register with
`track_thread`.
"""

from __future__ import annotations

import threading
import weakref

_oneshot: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()
_closers: "weakref.WeakSet" = weakref.WeakSet()
_lock = threading.Lock()
_registered = False


# Longest wait for any one worker at interpreter exit.  Compiles
# normally finish in seconds; a worker still alive after this is wedged,
# and hanging exit forever is worse than the (unlikely) teardown abort
# the join exists to prevent.
SHUTDOWN_JOIN_SECONDS = 60.0


def _shutdown() -> None:
    for obj in list(_closers):
        try:
            obj.close()
        except Exception:
            pass
    for t in list(_oneshot):
        if t.is_alive():
            t.join(timeout=SHUTDOWN_JOIN_SECONDS)
            if t.is_alive():  # pragma: no cover - wedged native call
                import sys

                print(f"tuun_jax: worker {t.name} still running after "
                      f"{SHUTDOWN_JOIN_SECONDS:.0f}s at exit; abandoning",
                      file=sys.stderr)


def _ensure_registered() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        _registered = True
        try:
            # Internal but stable since 3.9; runs before thread teardown.
            threading._register_atexit(_shutdown)  # type: ignore[attr-defined]
        except Exception:  # pragma: no cover - very old interpreters
            import atexit

            atexit.register(_shutdown)


def track_thread(t: threading.Thread) -> None:
    """Join `t` at interpreter shutdown (one-shot workers)."""
    _ensure_registered()
    _oneshot.add(t)


def track_closer(obj) -> None:
    """Call `obj.close()` at interpreter shutdown (loop workers)."""
    _ensure_registered()
    _closers.add(obj)
