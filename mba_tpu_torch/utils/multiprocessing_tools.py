"""IPC primitives for the real-time acquisition subsystem (a copy of
``mba_tpu/utils/multiprocessing_tools.py``).

Parity target: reference ``src/utils/multiprocessing_tools.py`` —
event→terminate→kill process teardown escalation (:4-22), a counted Event
that survives missed triggers (:25-65), and a lock-guarded UTF-8 shared
string buffer (:68-195).
"""
from __future__ import annotations

import multiprocessing as mp
import time


def save_terminate_process(process: mp.Process,
                           stop_event=None,
                           timeout_sec: float = 3.0) -> None:
    """Graceful teardown escalation: event → terminate → kill.

    Parity: reference multiprocessing_tools.py:4-22.
    """
    if process is None or not process.is_alive():
        return
    if stop_event is not None:
        stop_event.set()
        process.join(timeout=timeout_sec)
    if process.is_alive():
        process.terminate()
        process.join(timeout=timeout_sec)
    if process.is_alive():
        process.kill()
        process.join()


class RobustEventManager:
    """Counted event: triggers are never lost to races.

    The reference (:25-65) counts set() calls so a waiter that was busy
    during a trigger still observes it; waits poll in bounded slices so a
    dead peer cannot deadlock the waiter.
    """

    def __init__(self, manager: mp.Manager | None = None):
        manager = manager or mp.Manager()
        self._event = manager.Event()
        self._count = manager.Value('i', 0)
        self._seen = manager.Value('i', 0)
        self._lock = manager.Lock()

    def set(self) -> None:
        with self._lock:
            self._count.value += 1
            self._event.set()

    def is_set(self) -> bool:
        with self._lock:
            return self._count.value > self._seen.value

    def clear(self) -> None:
        with self._lock:
            self._seen.value = self._count.value
            self._event.clear()

    def wait(self, timeout: float | None = None,
             slice_sec: float = 1.0) -> bool:
        """Wait until a trigger is pending; polls in 1-s slices."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.is_set():
                return True
            remaining = (slice_sec if deadline is None
                         else min(slice_sec, deadline - time.monotonic()))
            if remaining <= 0:
                return False
            self._event.wait(remaining)

    def consume(self) -> bool:
        """Atomically observe-and-clear one pending trigger."""
        with self._lock:
            if self._count.value > self._seen.value:
                self._seen.value += 1
                if self._seen.value >= self._count.value:
                    self._event.clear()
                return True
            return False


class SharedString:
    """Lock-guarded UTF-8 string in a multiprocessing.Array buffer.

    Parity: reference multiprocessing_tools.py:68-195.
    """

    def __init__(self, initial_value: str = "", max_bytes: int = 1024):
        self._max_bytes = max_bytes
        self._array = mp.Array('B', max_bytes)
        self._length = mp.Value('i', 0)
        self.set(initial_value)

    def set(self, value: str) -> None:
        encoded = value.encode("utf-8")
        if len(encoded) > self._max_bytes:
            # truncate at a valid UTF-8 boundary
            encoded = encoded[:self._max_bytes]
            while encoded and (encoded[-1] & 0xC0) == 0x80:
                encoded = encoded[:-1]
        with self._array.get_lock():
            self._array[:len(encoded)] = encoded
            self._length.value = len(encoded)

    def get(self) -> str:
        with self._array.get_lock():
            raw = bytes(self._array[:self._length.value])
        return raw.decode("utf-8", errors="replace")

    @property
    def value(self) -> str:
        return self.get()

    @value.setter
    def value(self, new_value: str) -> None:
        self.set(new_value)

    def __str__(self) -> str:
        return self.get()
