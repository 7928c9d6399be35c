"""Memoized communication plans (DESIGN.md §14).

``planner.plan`` is deterministic in ``(topology fingerprint,
grad-layout signature, planner knobs)`` — the fingerprint
(``HetTopology.fingerprint``) canonicalizes cluster order and names, so
every topology that prices identically shares one cache line.  Launch
flows hit the same key over and over: hillclimb re-plans per iteration
while only non-topology knobs change, MoE dispatch plans repeat per
layer, and the skew optimizer prices many batch splits whose underlying
candidate search is knob-identical (the planner strips the skew
annotation from both the key and the stored plan and re-attaches it on
hit — the split shifts every candidate's straggler score by the same
constant, so it never changes the choice).

The cache is a plain insertion-ordered LRU.  With ``path`` set it
persists itself with pickle after every store, which is what lets
hillclimb's *subprocess* iterations share plans: each ``dryrun`` run
loads the file, usually hits, and reports ``stats()`` in its result
JSON for the hillclimb report to aggregate.

Invalidation is explicit: ``invalidate()`` drops everything,
``invalidate(fingerprint)`` drops one topology's plans — the hook the
elastic re-planning frontier needs when a pod departs (the new
topology has a new fingerprint, but the old one's lines are garbage).

The PyTorch port's copy reads a cache file through an unpickler that
admits only classes of ``repro_torch`` and builtins: a file written by
the JAX package names that package's classes, and loading it would
import the package (and JAX) into the port's process.  Such a file is a
cold cache, as any unreadable file is.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

_MISS = object()


class _PortUnpickler(pickle.Unpickler):
    """Loads only classes of this package and builtins."""

    def find_class(self, module: str, name: str) -> Any:
        if module == "builtins" or module.split(".")[0] == "repro_torch":
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not a class of the port")


class PlanCache:
    """LRU cache of ``planner.CommPlan`` values, optionally disk-backed.

    ``key`` structure is owned by ``planner._plan_key``; this class only
    relies on ``key[0]`` being the topology fingerprint (for
    per-topology invalidation).  Hit/miss counters are cumulative per
    instance and surface in launcher result JSONs."""

    def __init__(self, path: str | None = None, maxsize: int = 256):
        self.path = path
        self.maxsize = max(1, int(maxsize))
        self.hits = 0
        self.misses = 0
        self.invalidations = 0      # invalidate() calls (elastic replans)
        self.invalidated_entries = 0  # cache lines those calls dropped
        self._store: dict[Any, Any] = {}
        if path:
            self._load()

    # -- persistence -------------------------------------------------------
    def _load(self) -> None:
        try:
            with open(self.path, "rb") as f:
                loaded = _PortUnpickler(f).load()
            if isinstance(loaded, dict):
                self._store = loaded
        except (OSError, EOFError, pickle.UnpicklingError, AttributeError,
                ImportError):
            # unreadable/stale cache files are equivalent to a cold cache
            self._store = {}

    def _save(self) -> None:
        if not self.path:
            return
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(self._store, f)
            os.replace(tmp, self.path)
        except OSError:
            pass  # a cache that cannot persist is still a valid cache

    # -- the cache ---------------------------------------------------------
    def get(self, key: Any) -> Any | None:
        value = self._store.get(key, _MISS)
        if value is _MISS:
            self.misses += 1
            return None
        self.hits += 1
        # refresh recency so the LRU eviction order tracks use, not
        # just insertion
        self._store.pop(key)
        self._store[key] = value
        return value

    def put(self, key: Any, value: Any) -> None:
        self._store.pop(key, None)
        self._store[key] = value
        while len(self._store) > self.maxsize:
            self._store.pop(next(iter(self._store)))
        self._save()

    def invalidate(self, fingerprint: Any | None = None) -> int:
        """Drop every entry (default) or only the entries planned for
        the given topology fingerprint; returns how many were dropped."""
        if fingerprint is None:
            n = len(self._store)
            self._store.clear()
        else:
            doomed = [k for k in self._store if k[0] == fingerprint]
            for k in doomed:
                self._store.pop(k)
            n = len(doomed)
        self.invalidations += 1
        self.invalidated_entries += n
        self._save()
        return n

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._store),
                "invalidations": self.invalidations,
                "invalidated_entries": self.invalidated_entries,
                "path": self.path}

    def __len__(self) -> int:
        return len(self._store)
