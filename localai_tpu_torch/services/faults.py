"""Fault-injection registry (a copy of localai_tpu/services/faults.py):
the chaos tests' backbone.

A process-wide table of ARMED faults that the engine consults at its
injection points. With nothing armed, every hook is one boolean
attribute read (`FAULTS.active`) — the harness costs nothing in normal
serving.

Spec format (env ``LOCALAI_FAULTS``, read at import, or ``configure`` —
semicolon-separated)::

    name[=value][*count] [; name2[=value2][*count2] ...]

``count`` is how many times the fault FIRES before disarming itself
(default 1 — one-shot faults keep chaos runs deterministic: the fault
hits exactly once and the survivors' behavior is comparable to a
fault-free run). ``*`` alone means unlimited.

Injection points of the port (grep for ``FAULTS.take``); the JAX
package's other points belong to modules the port has not taken yet:

==========================  =================================================
``sync_delay_ms=N``              engine/engine.py ``_sync_faults``: the
                                 results of the next pack or burst the loop
                                 asks about land N ms late (stall injection)
``sync_fail``                    the same hook: that item's results fail
``page_alloc_fail``              engine ``_ensure_pages``: raise PoolExhausted
``host_store_corrupt``           engine/kv_offload.py ``get``: flip a byte in
                                 the stored page (the checksum must catch it)
``emitter_wedge_ms=N``           engine/emitter.py worker loop: sleep N ms on
                                 one item (the wedged-emitter watchdog)
``kv_leak``                      engine/prefix_cache.py ``_remove_tree``:
                                 skip one retention ``drop()`` at the eviction
                                 seam, a refcount leak the online KV auditor
                                 must find
==========================  =================================================
"""

from __future__ import annotations

import os
import threading
from typing import Optional

_UNLIMITED = -1


class FaultInjector:
    """Thread-safe armed-fault table. ``active`` is a plain attribute so
    hot paths skip the lock entirely when nothing is armed."""

    def __init__(self):
        self._lock = threading.Lock()
        self._faults: dict[str, list] = {}   # name -> [value, remaining]
        self.fired: dict[str, int] = {}      # name -> times fired (telemetry)
        self.active = False

    # ---- arming ----

    def configure(self, spec: str) -> None:
        """Merge a ``name[=value][*count];...`` spec into the table."""
        for item in (spec or "").split(";"):
            item = item.strip()
            if not item:
                continue
            count = 1
            if "*" in item:
                item, _, c = item.rpartition("*")
                count = _UNLIMITED if c.strip() in ("", "inf") else int(c)
            name, _, value = item.partition("=")
            self.arm(name.strip(), value.strip() or "1", count)

    def arm(self, name: str, value: str = "1", count: int = 1) -> None:
        with self._lock:
            self._faults[name] = [value, count]
            self.active = True

    def disarm(self, name: str) -> None:
        with self._lock:
            self._faults.pop(name, None)
            self.active = bool(self._faults)

    def reset(self) -> None:
        with self._lock:
            self._faults.clear()
            self.fired.clear()
            self.active = False

    # ---- firing ----

    def value(self, name: str) -> Optional[str]:
        """Peek an armed fault's value WITHOUT consuming a firing."""
        with self._lock:
            f = self._faults.get(name)
            return f[0] if f else None

    def take(self, name: str, match: Optional[str] = None) -> Optional[str]:
        """Consume one firing of ``name``; returns its value or None.

        ``match`` gates value-addressed faults (``rpc_unavailable=Embedding``
        only fires for take("rpc_unavailable", match="Embedding"))."""
        with self._lock:
            f = self._faults.get(name)
            if f is None or (match is not None and f[0] != match):
                return None
            value, remaining = f
            if remaining != _UNLIMITED:
                if remaining <= 1:
                    del self._faults[name]
                    self.active = bool(self._faults)
                else:
                    f[1] = remaining - 1
            self.fired[name] = self.fired.get(name, 0) + 1
            return value

    def snapshot(self) -> dict:
        with self._lock:
            return {"armed": {k: {"value": v[0], "remaining": v[1]}
                              for k, v in self._faults.items()},
                    "fired": dict(self.fired)}


FAULTS = FaultInjector()
# env arming happens at import so spawned backends (BackendProcess copies
# os.environ) inherit the chaos configuration with zero plumbing
FAULTS.configure(os.environ.get("LOCALAI_FAULTS", ""))
