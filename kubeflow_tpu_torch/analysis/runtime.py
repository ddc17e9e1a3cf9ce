"""Runtime auditors of the serving engine: the port of what it needs from
``kubeflow_tpu/analysis/runtime.py``.

- :class:`CaptureCounter`: the counterpart of the reference's
  ``RecompileCounter``. The reference counts jit-cache growth past each
  program's first compile; the port's programs are CUDA graphs, so it
  counts graph captures (on the CPU, where programs run eagerly, the first
  use of a program shape). Captures before the counter is armed are the
  warmup's paid-once set; the engine arms it when warmup ends, and every
  later capture counts: a capture stalls every live request, so the
  engine's ``graph_captures_total`` gauge must stay 0.
- :class:`BlockLedger`: copied from the reference: shadow refcounts over a
  ``BlockAllocator``'s ``alloc``/``ref``/``release``, the
  zero-leaked-blocks audit, and the host tier's conservation check over a
  ``HostBlockPool`` (``attach_host_pool``/``audit_host``).
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Iterable, Optional


class CaptureCounter:
    """Shared capture tally of one engine. ``warmup`` counts the captures
    made before ``armed``; ``count`` those after, which must stay 0."""

    __slots__ = ("count", "warmup", "armed")

    def __init__(self) -> None:
        self.count = 0
        self.warmup = 0
        self.armed = False

    def note(self) -> None:
        """Record one capture."""
        if self.armed:
            self.count += 1
        else:
            self.warmup += 1


class _Books:
    """One allocator's shadow state inside a BlockLedger."""

    __slots__ = ("alloc", "name", "rc", "owners", "origins", "reported")

    def __init__(self, alloc: Any, name: str):
        self.alloc = alloc
        self.name = name
        #: block -> shadow refcount (tracked while > 0)
        self.rc: dict[int, int] = {}
        #: block -> sequence/owner label (engine annotations)
        self.owners: dict[int, str] = {}
        #: block -> call-site label captured at alloc time
        self.origins: dict[int, str] = {}
        #: blocks already counted into leaked_total (a still-leaked
        #: block re-audited at the next boundary must not re-count)
        self.reported: set[int] = set()


class BlockLedger:
    """Runtime audit of the paged-KV block economy (the dynamic half of
    the zero-leaked-blocks contract).

    Usage (migration/resize parity suites)::

        ledger = BlockLedger()
        src.attach_block_ledger(ledger)     # wraps src._alloc in place
        dst.attach_block_ledger(ledger)     # one ledger, both economies
        ... run the scenario ...
        assert ledger.conservation_errors == []
        assert src.stats()["kv_blocks_leaked_total"] == 0

    One ledger may attach to SEVERAL allocators (source + destination of
    a migration, old + new degree of a resize); books are per-allocator,
    the ``leaked_total`` tally is shared — "zero leaked blocks on both
    allocators" is one assert.

    What each wrapped verb checks, synchronously on the calling
    (scheduler) thread:

    - ``alloc``  — every granted block was free and now has refcount 1;
      the grant is recorded with its caller (``origin``) so a leak
      report names the allocation site, not just the block id.
    - ``ref``    — shadow count increments with the allocator's; a
      resurrection (ref on a free registered block) opens a new entry.
    - ``release``— shadow count decrements; a release of a block the
      ledger never saw allocated is recorded as a conservation error
      (the allocator's own over-release raise still fires first when
      the REAL count goes negative).

    After every verb the touched blocks' shadow counts are compared to
    the allocator's real ``_refs`` — any drift means some code path
    mutated the economy around the wrapped verbs, and is recorded into
    :attr:`conservation_errors` at the op that exposed it.

    ``audit_quiesced(alloc, held)`` is the boundary check: every block
    still referenced must be in ``held`` (the blocks live sequences
    legitimately hold); the rest are LEAKS — counted once each into
    ``leaked_total`` and returned with owner + origin attribution.  The
    engine calls it automatically when its pool goes fully idle and on
    the ``audit`` mailbox op; tests call it at retire/cutover/resize
    boundaries.
    """

    def __init__(self) -> None:
        # RLock: the verb hooks take it around book mutation and may
        # record an error (which takes it again) mid-check; audits on
        # other threads (a test auditing a stopped engine) then iterate
        # the same books safely
        self._mu = threading.RLock()
        #: books by id(allocator), and by ("host", id(pool)) for host tiers
        self._books: dict[Any, _Books] = {}
        self.leaked_total = 0
        self.ops_total = 0
        #: conservation violations observed (bounded; each is one
        #: human-readable line) — tests assert this stays empty
        self.conservation_errors: list[str] = []
        self._max_errors = 64

    # -- attachment --------------------------------------------------------

    def attach(self, alloc: Any, name: str = "") -> Any:
        """Wrap ``alloc``'s economy verbs in place (idempotent).  Blocks
        already allocated open the books with their current refcounts
        (origin ``pre-attach``).

        Attach at a QUIESCENT boundary — before the engine starts, or
        while its scheduler is idle (the engine's
        ``attach_block_ledger`` callers all do).  The snapshot and the
        wrapper installation happen under the ledger lock, so
        concurrent ``attach`` calls are safe; but an economy op racing
        the installation on ANOTHER thread could slip between snapshot
        and wrap unobserved and surface later as a spurious
        conservation error — quiescence is the caller's contract."""
        with self._mu:
            if id(alloc) in self._books:
                return alloc
            books = _Books(alloc, name or f"alloc@{len(self._books)}")
            for b in range(alloc.num_blocks):
                n = int(alloc._refs[b])
                if n > 0:
                    books.rc[b] = n
                    books.origins[b] = "pre-attach"

            orig_alloc, orig_ref = alloc.alloc, alloc.ref
            orig_release = alloc.release

            def alloc_wrapped(n: int):
                out = orig_alloc(n)
                if out is not None:
                    self._on_alloc(books, out)
                return out

            def ref_wrapped(blocks):
                blocks = list(blocks)
                orig_ref(blocks)
                self._on_ref(books, blocks)

            def release_wrapped(blocks):
                blocks = list(blocks)
                orig_release(blocks)  # over-release raises HERE first
                self._on_release(books, blocks)

            alloc.alloc = alloc_wrapped
            alloc.ref = ref_wrapped
            alloc.release = release_wrapped
            self._books[id(alloc)] = books
        return alloc

    def _book(self, alloc: Any) -> Optional[_Books]:
        with self._mu:
            return self._books.get(id(alloc))

    # -- verb hooks --------------------------------------------------------

    def _error(self, books: _Books, msg: str) -> None:
        with self._mu:
            if len(self.conservation_errors) < self._max_errors:
                self.conservation_errors.append(f"[{books.name}] {msg}")

    def _check(self, books: _Books, blocks: Iterable[int]) -> None:
        """Shadow-vs-real refcount comparison for the touched blocks."""
        for b in blocks:
            real = int(books.alloc._refs[b])
            shadow = books.rc.get(b, 0)
            if real != shadow:
                self._error(
                    books,
                    f"block {b}: shadow refcount {shadow} != allocator "
                    f"{real} — a code path mutates the economy around "
                    "the wrapped verbs")
                # resync so one drift reports once, not at every op
                if real > 0:
                    books.rc[b] = real
                else:
                    books.rc.pop(b, None)

    def _origin(self) -> str:
        # the wrapped verb's caller: _origin <- _on_alloc <- wrapper <- site
        f = sys._getframe(3)
        return f.f_code.co_name

    def _on_alloc(self, books: _Books, blocks: list) -> None:
        origin = self._origin()
        with self._mu:
            self.ops_total += 1
            for b in blocks:
                b = int(b)
                if books.rc.get(b, 0) != 0:
                    self._error(
                        books, f"block {b} granted by alloc while shadow "
                        f"refcount is {books.rc[b]} (owner "
                        f"{books.owners.get(b, '?')}) — double grant")
                books.rc[b] = 1
                books.origins[b] = origin
                books.owners.pop(b, None)
                books.reported.discard(b)
            self._check(books, map(int, blocks))

    def _on_ref(self, books: _Books, blocks: list) -> None:
        origin = self._origin()
        with self._mu:
            self.ops_total += 1
            for b in blocks:
                b = int(b)
                if b not in books.rc:
                    # resurrection out of the free list (prefix hit on a
                    # retired conversation's registered blocks)
                    books.origins[b] = origin
                    books.reported.discard(b)
                books.rc[b] = books.rc.get(b, 0) + 1
            self._check(books, map(int, blocks))

    def _on_release(self, books: _Books, blocks: list) -> None:
        with self._mu:
            self.ops_total += 1
            for b in blocks:
                b = int(b)
                if b not in books.rc:
                    self._error(
                        books, f"block {b} released but the ledger never "
                        "saw it allocated — unbalanced release")
                    continue
                books.rc[b] -= 1
                if books.rc[b] <= 0:
                    books.rc.pop(b, None)
                    books.owners.pop(b, None)
                    books.reported.discard(b)
            self._check(books, map(int, blocks))

    # -- annotations -------------------------------------------------------

    def annotate(self, alloc: Any, blocks: Iterable[int],
                 owner: str) -> None:
        """Tag ``blocks`` with the owning sequence (the engine calls
        this at admission/import so leak reports name the sequence)."""
        books = self._book(alloc)
        if books is None:
            return
        with self._mu:
            for b in blocks:
                books.owners[int(b)] = owner

    # -- audits ------------------------------------------------------------

    def live(self, alloc: Any) -> dict[int, int]:
        """Shadow refcounts currently > 0 for ``alloc``."""
        books = self._book(alloc)
        if books is None:
            return {}
        with self._mu:
            return dict(books.rc)

    def verify(self, alloc: Any) -> list[str]:
        """Full-sweep conservation check: every block's shadow count vs
        the allocator's, plus free-list consistency.  Returns NEW error
        lines (also appended to :attr:`conservation_errors`)."""
        books = self._book(alloc)
        if books is None:
            return []
        with self._mu:
            before = len(self.conservation_errors)
            self._check(books, range(alloc.num_blocks))
            for b in range(alloc.num_blocks):
                free = b in alloc._free
                refd = int(alloc._refs[b]) > 0
                if free and refd:
                    self._error(books,
                                f"block {b} is on the free list with "
                                f"refcount {int(alloc._refs[b])}")
                elif not free and not refd:
                    self._error(books,
                                f"block {b} has refcount 0 but is not "
                                "on the free list — unreachable forever")
            return self.conservation_errors[before:]

    def audit_quiesced(self, alloc: Any,
                       held: Iterable[int] = ()) -> list[dict]:
        """The boundary check: blocks still referenced but NOT in
        ``held`` are leaks.  Each leak counts once into
        ``leaked_total`` (re-audits of a still-leaked block are free)
        and is returned with its owner/origin attribution."""
        books = self._book(alloc)
        if books is None:
            return []
        held_set = {int(b) for b in held}
        leaks: list[dict] = []
        with self._mu:
            for b, n in sorted(books.rc.items()):
                if n <= 0 or b in held_set:
                    continue
                leaks.append({
                    "block": b, "refcount": n, "books": books.name,
                    "owner": books.owners.get(b, ""),
                    "origin": books.origins.get(b, ""),
                })
                if b not in books.reported:
                    books.reported.add(b)
                    self.leaked_total += 1
        return leaks

    # -- host tier -----------------------------------------------------------

    def attach_host_pool(self, pool: Any, name: str = "host") -> Any:
        """Extend the shadow count to a ``HostBlockPool`` (the host-RAM KV
        tier): ``put`` and the LRU eviction are wrapped so the pool's
        ``blocks_held`` gauge is conservation-checked against its entry
        map after every op. Idempotent."""
        with self._mu:
            key = ("host", id(pool))
            if key in self._books:
                return pool
            books = _Books(pool, name)
            self._books[key] = books

            orig_put, orig_evict = pool.put, pool._evict_oldest

            def put_wrapped(tokens, blocks, nbytes=None):
                out = orig_put(tokens, blocks, nbytes)
                self.ops_total += 1
                with pool._lock:
                    # put has returned: the eviction loop converged, so the
                    # capacity bound holds here
                    self._check_host(books, pool, check_capacity=True)
                return out

            def evict_wrapped():
                # runs inside put with pool._lock held (the only eviction
                # site): check without re-locking and without the capacity
                # bound, which mid-loop is legitimately exceeded
                orig_evict()
                self._check_host(books, pool)

            pool.put = put_wrapped
            pool._evict_oldest = evict_wrapped
        return pool

    def _check_host(self, books: _Books, pool: Any,
                    check_capacity: bool = False) -> None:
        actual = sum(len(e["blocks"]) for e in pool._seqs.values())
        if actual != pool.blocks_held:
            self._error(
                books, f"host tier holds {actual} blocks but the gauge "
                f"says {pool.blocks_held} — a spill/evict path mutates "
                "the tier around the wrapped verbs")
            pool.blocks_held = actual  # resync: one drift reports once
        if check_capacity and pool.blocks_held > pool.capacity_blocks:
            self._error(
                books, f"host tier over capacity: {pool.blocks_held} > "
                f"{pool.capacity_blocks} — eviction did not converge")

    def audit_host(self, pool: Any) -> list[str]:
        """Boundary check of the host tier: re-run the conservation count
        and return the NEW error lines (empty = the gauges are honest and
        occupancy is within capacity). Lock order: ``pool._lock`` before
        the ledger's, as on the wrapped verbs' paths."""
        with self._mu:
            books = self._books.get(("host", id(pool)))
        if books is None:
            return []
        with pool._lock:
            with self._mu:
                before = len(self.conservation_errors)
                self._check_host(books, pool, check_capacity=True)
                return self.conservation_errors[before:]
