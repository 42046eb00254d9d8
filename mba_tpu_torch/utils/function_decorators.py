"""Resilience decorators (a copy of ``mba_tpu/utils/function_decorators.py``).

Parity target: reference ``src/utils/function_decorators.py`` —
exponential-backoff progress heartbeats for long callbacks (:6-66) and a
generic retry decorator (:69-109).
"""
from __future__ import annotations

import functools
import time


def timed_callback_decorator(initial_interval_sec: float = 5.0,
                             backoff_factor: float = 2.0,
                             label: str | None = None):
    """Emit heartbeat prints at exponentially growing intervals while the
    wrapped function is (repeatedly) invoked."""

    def decorator(func):
        state = {"start": None, "next_ping": initial_interval_sec}

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            now = time.monotonic()
            if state["start"] is None:
                state["start"] = now
            elapsed = now - state["start"]
            if elapsed >= state["next_ping"]:
                print(f"[heartbeat] {label or func.__name__} running for "
                      f"{elapsed:.0f}s")
                state["next_ping"] *= backoff_factor
            return func(*args, **kwargs)

        return wrapper
    return decorator


def retry_decorator(n_retries: int = 3, delay_sec: float = 1.0,
                    backoff_factor: float = 2.0,
                    exceptions: tuple = (Exception,),
                    verbose: bool = True):
    """Retry the wrapped function with exponential backoff."""

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            delay = delay_sec
            for attempt in range(n_retries + 1):
                try:
                    return func(*args, **kwargs)
                except exceptions as e:
                    if attempt == n_retries:
                        raise
                    if verbose:
                        print(f"[retry] {func.__name__} failed "
                              f"({type(e).__name__}: {e}); retrying in "
                              f"{delay:.1f}s ({attempt + 1}/{n_retries})")
                    time.sleep(delay)
                    delay *= backoff_factor
        return wrapper
    return decorator
