"""BaseService: start/stop lifecycle with idempotence guarantees.

Reference: libs/service/service.go (Service interface, BaseService:
Start/Stop/Reset, OnStart/OnStop hooks, IsRunning, Quit channel — the
quit channel maps to a threading.Event here).

The port's copy of the JAX package's libs/service.py.
"""
from __future__ import annotations

import threading


class ServiceError(Exception):
    pass


class BaseService:
    def __init__(self, name: str = ""):
        self.name = name or type(self).__name__
        self._started = False
        self._stopped = False
        self._quit = threading.Event()
        self._lock = threading.Lock()

    def start(self) -> None:
        with self._lock:
            if self._started:
                raise ServiceError(f"{self.name} already started")
            if self._stopped:
                raise ServiceError(f"{self.name} already stopped")
            self._started = True
        self.on_start()

    def stop(self) -> None:
        with self._lock:
            if not self._started or self._stopped:
                return
            self._stopped = True
        self._quit.set()
        self.on_stop()

    def is_running(self) -> bool:
        return self._started and not self._stopped

    def wait(self, timeout=None) -> bool:
        return self._quit.wait(timeout)

    @property
    def quit_event(self) -> threading.Event:
        return self._quit

    # hooks
    def on_start(self) -> None:  # pragma: no cover - trivial
        pass

    def on_stop(self) -> None:  # pragma: no cover - trivial
        pass
