"""Retained prefix cache: a page-granular trie with LRU eviction
(counterpart of ``repro.serve.prefix_cache``; host logic, the same
structure and keys).

``PrefixIndex`` is advice about live slots: nothing in it holds a
reference, so once a popular prompt's last holder retires its pages go
back to the free list. This cache keeps them, over the same
``PagePool`` refcounts:

  * **donation** — a retiring request's full written pages go to the
    trie instead of being freed; the cache inherits the retiree's
    reference, so no count moves and the remainder rides the round's one
    retirement ``free_batch``;
  * **adoption** — admission walks the trie for the longest match of the
    prompt's full-page digest chain; the pages are incref'd by the
    admission grant's ``incref_groups`` rider (no new acquire);
  * **eviction** — when grants would drag the free list under the
    watermark, least-recently-used leaves are trimmed from their tail,
    and their decrefs ride the round's top-up or admission section
    (``decref_groups``), before its grants.

Each node owns a run of consecutive pages; a donation that diverges
mid-run splits the node at the divergence page. Keys are the chained
``blake2b`` page digests of ``PrefixIndex``, rooted per ``(bucket,
schedule)`` suffix, so one-shot and chunked donors never cross-adopt.

Pages written by decode (a donor's reply) are retained too, which is
what lets a multi-turn chat re-serve its whole previous conversation;
their K/V equals a fresh prefill's up to rounding, so
``adopt_policy="prompt"`` refuses to match past the first generated
page where bit-identity by construction is wanted.

The trie is mutated by the engine thread between rounds; ``_lock`` (a
bookkeeping lock, never held across an allocator section) makes it safe
for threaded callers. Every refcount move goes through ``PagePool``.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PrefixCache", "cache_key_suffix"]


def cache_key_suffix(bucket: int, schedule: int = 0) -> bytes:
    """Shape-identity suffix a trie root is keyed by — the same
    ``(bucket, schedule)`` pair ``PrefixIndex._key`` appends per entry:
    one-shot prefill donors use ``(prefill_bucket, 0)``, chunked donors
    ``(0, C)``. Roots never cross-match, so adopted bits always come
    from a donor whose prompt positions were written at the adopter's
    own dispatch shape."""
    return (int(bucket).to_bytes(4, "little")
            + int(schedule).to_bytes(4, "little"))


class _Node:
    """One trie node: a run of consecutive pages along one prefix path.

    ``digests[i]`` is the chained digest of the *whole token prefix* up
    to and including the run's ``i``-th page — chain equality implies
    prefix equality, so child edges keyed by the child's first digest
    are collision-free without storing tokens. ``generated[i]`` marks
    pages holding decode-written positions (the bit-exactness tier).
    """

    __slots__ = ("digests", "pages", "epochs", "generated",
                 "children", "parent", "last_use")

    def __init__(self, digests: List[bytes], pages: List[int],
                 epochs: List[int], generated: List[bool],
                 parent: Optional["_Node"], last_use: int):
        self.digests = digests
        self.pages = pages
        self.epochs = epochs
        self.generated = generated
        self.children: Dict[bytes, "_Node"] = {}
        self.parent = parent
        self.last_use = last_use

    def __len__(self) -> int:
        return len(self.pages)


class PrefixCache:
    """Page-granular retained prefix trie over ``PagePool`` refcounts.

    The cache OWNS one reference per page it holds (inherited from the
    donor at donation time); ``holders()`` exposes the ownership
    multiset so ``PagedSlotPool.check`` can keep its "every reference
    is accounted for" invariant with cache-held pages in play.
    """

    def __init__(self, page_size: int, pool,
                 adopt_policy: str = "all"):
        if adopt_policy not in ("all", "prompt"):
            raise ValueError(f"unknown adopt_policy {adopt_policy!r}")
        self.page_size = int(page_size)
        self.pool = pool
        self.adopt_policy = adopt_policy
        self._roots: Dict[bytes, _Node] = {}
        self._lock = threading.Lock()
        self._clock = 0
        # counters (engine stats / benchmarks)
        self.hits = 0              # lookups that matched >= 1 page
        self.misses = 0
        self.pages_donated = 0     # references inherited from retirees
        self.pages_duplicate = 0   # donated pages already covered (decref'd)
        self.pages_evicted = 0     # references dropped by LRU eviction
        self.pages_adopted = 0     # increfs handed to admitted requests
        self.pages_held = 0        # references currently owned

    # ------------------------------------------------------------- hashing
    def _digests(self, tokens: np.ndarray) -> List[bytes]:
        """Chained digest per FULL page of ``tokens`` (the cache is
        page-granular: partial tails stay the live index's business)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        h = hashlib.blake2b(digest_size=16)
        out: List[bytes] = []
        for j in range(tokens.size // ps):
            h.update(tokens[j * ps:(j + 1) * ps].tobytes())
            out.append(h.copy().digest())
        return out

    def _root(self, suffix: bytes) -> _Node:
        node = self._roots.get(suffix)
        if node is None:
            node = _Node([], [], [], [], None, 0)
            self._roots[suffix] = node
        return node

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        now = self._clock
        while node is not None:
            node.last_use = now
            node = node.parent

    # ------------------------------------------------------------ donation
    def donate(self, tokens, page_ids, suffix: bytes, *,
               generated_from: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Offer a retiring request's written prefix to the trie.

        ``tokens`` are the positions actually written (prompt followed
        by any decode-written reply tokens); ``page_ids`` the pages
        holding them, in position order. Only the full pages both cover
        are considered. ``generated_from`` is the position index where
        decode-written content starts (``None`` = pure prompt).

        Returns ``(kept, duplicates)``: ``kept`` pages are now OWNED by
        the cache — the caller must NOT decref them (the cache inherits
        the retiree's reference); ``duplicates`` matched a chain the
        trie already holds and must be decref'd exactly as a plain
        retirement would (they ride the round's retirement
        ``free_batch``).
        """
        page_ids = np.asarray(page_ids, np.int32).reshape(-1)
        digests = self._digests(tokens)
        n = min(len(digests), int(page_ids.size))
        if n == 0:
            return np.zeros(0, np.int32), page_ids[:0]
        digests = digests[:n]
        ids = page_ids[:n]
        epochs = self.pool.epochs(ids).tolist()
        gen = [False] * n
        if generated_from is not None:
            for j in range(n):
                if (j + 1) * self.page_size > int(generated_from):
                    gen[j] = True
        with self._lock:
            return self._donate_locked(digests, ids, epochs, gen, suffix)

    def _donate_locked(self, digests, ids, epochs, gen,
                       suffix: bytes) -> Tuple[np.ndarray, np.ndarray]:
        node = self._root(suffix)
        i = 0
        n = len(digests)
        dup: List[int] = []
        kept = np.zeros(0, np.int32)
        while i < n:
            child = node.children.get(digests[i])
            if child is None:
                new = _Node(list(digests[i:]), [int(p) for p in ids[i:]],
                            list(epochs[i:]), list(gen[i:]), node, 0)
                node.children[new.digests[0]] = new
                kept = np.asarray(ids[i:], np.int32)
                self.pages_donated += int(kept.size)
                self.pages_held += int(kept.size)
                node = new
                break
            j = 0
            while (j < len(child.digests) and i < n
                   and child.digests[j] == digests[i]):
                dup.append(int(ids[i]))
                # refresh the retained bit-exactness tier: a prompt-
                # schedule re-donation of a page the trie only knew as
                # generated upgrades it (content identical by digest)
                if not gen[i]:
                    child.generated[j] = False
                i += 1
                j += 1
            if i >= n:
                break
            if j < len(child.digests):
                # divergence INSIDE the run: split the child at the
                # exact divergence page — the head now holds exactly the
                # matched pages — then descend INTO it so the divergent
                # branch attaches at the split point (not the parent,
                # where no lookup could ever reach it)
                self._split(child, j)
            node = child
        self.pages_duplicate += len(dup)
        self._touch(node)
        return kept, np.asarray(dup, np.int32)

    def _split(self, node: _Node, at: int) -> None:
        """Split ``node``'s run at page index ``at`` (> 0): the head
        keeps pages ``[0, at)``, a new tail node owns ``[at, ...)`` and
        inherits the children — the trie's physical pages are untouched
        (both halves stay cache-owned)."""
        assert 0 < at < len(node.pages)
        tail = _Node(node.digests[at:], node.pages[at:],
                     node.epochs[at:], node.generated[at:],
                     node, node.last_use)
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        node.digests = node.digests[:at]
        node.pages = node.pages[:at]
        node.epochs = node.epochs[:at]
        node.generated = node.generated[:at]
        node.children = {tail.digests[0]: tail}

    # ------------------------------------------------------------ adoption
    def lookup(self, tokens, suffix: bytes
               ) -> Tuple[int, Optional[np.ndarray]]:
        """Longest cached match of ``tokens``' full-page digest chain:
        ``(matched_tokens, page_ids)`` or ``(0, None)``. The caller
        must incref the returned pages under its admission critical
        section (``reserve_batch(shared=)``); the cache keeps its own
        reference regardless. Touches the matched path (LRU)."""
        digests = self._digests(tokens)
        with self._lock:
            node = self._roots.get(suffix)
            if node is None or not digests:
                self.misses += 1
                return 0, None
            out: List[int] = []
            eps: List[int] = []
            i = 0
            while i < len(digests):
                child = node.children.get(digests[i])
                if child is None:
                    break
                j = 0
                stop = False
                while (j < len(child.digests) and i < len(digests)
                       and child.digests[j] == digests[i]):
                    if (self.adopt_policy == "prompt"
                            and child.generated[j]):
                        stop = True     # strict tier: prompt pages only
                        break
                    out.append(child.pages[j])
                    eps.append(child.epochs[j])
                    i += 1
                    j += 1
                node = child
                if stop or j < len(child.digests):
                    break
            if not out:
                self.misses += 1
                return 0, None
            ids = np.asarray(out, np.int32)
            # belt-and-braces: cache-owned pages cannot be recycled
            # (we hold the refcount), so a donation-epoch mismatch here
            # is a protocol bug — surface it rather than adopt garbage
            if not self.pool.entry_valid(ids, np.asarray(eps, np.int64)):
                raise AssertionError(
                    "prefix cache owns a recycled page — a reference "
                    "escaped the donation/eviction protocol")
            self._touch(node)
            self.hits += 1
            self.pages_adopted += int(ids.size)
            return int(ids.size) * self.page_size, ids

    # ------------------------------------------------------------ eviction
    def _leaves(self) -> List[Tuple[bytes, _Node]]:
        out = []
        stack = [(sfx, c) for sfx, r in self._roots.items()
                 for c in r.children.values()]
        while stack:
            sfx, node = stack.pop()
            if not node.children:
                out.append((sfx, node))
            else:
                stack.extend((sfx, c) for c in node.children.values())
        return out

    def evict_plan(self, need_pages: int) -> Tuple[List[np.ndarray], int]:
        """Trim LRU leaves until dropping the planned references would
        return at least ``need_pages`` pages to the free list (pages
        some live slot still reads are decref'd but don't count — the
        free list gains nothing from them), or the cache is empty.

        Returns ``(groups, freeable)``. The caller MUST apply every
        group as decrefs in its next allocator critical section
        (``alloc_batch(decref_groups=)`` / ``free_batch``): the trie
        forgets the pages here, so dropping the plan would leak the
        references."""
        need = int(need_pages)
        groups: List[np.ndarray] = []
        freeable = 0
        with self._lock:
            while freeable < need:
                leaves = self._leaves()
                if not leaves:
                    break
                sfx, victim = min(leaves, key=lambda kv: kv[1].last_use)
                take_all = True
                drop_ids = victim.pages
                if freeable + len(victim.pages) > need:
                    # partial trim, tail pages first: the head of a run
                    # is the more reusable prefix
                    short = need - freeable
                    n_keep = len(victim.pages) - short
                    if n_keep > 0:
                        drop_ids = victim.pages[n_keep:]
                        rc = self.pool.refcounts(drop_ids)
                        victim.digests = victim.digests[:n_keep]
                        victim.pages = victim.pages[:n_keep]
                        victim.epochs = victim.epochs[:n_keep]
                        victim.generated = victim.generated[:n_keep]
                        take_all = False
                if take_all:
                    rc = self.pool.refcounts(victim.pages)
                    parent = victim.parent
                    del parent.children[victim.digests[0]]
                ids = np.asarray(drop_ids, np.int32)
                groups.append(ids)
                freeable += int((rc == 1).sum())
                self.pages_evicted += int(ids.size)
                self.pages_held -= int(ids.size)
        return groups, freeable

    def drop_all(self) -> List[np.ndarray]:
        """Forget everything; returns the owned page groups for the
        caller to decref (one ``free_batch``) — the leak-check drain
        used by benchmarks and the fuzz harness."""
        groups: List[np.ndarray] = []
        with self._lock:
            stack = [c for r in self._roots.values()
                     for c in r.children.values()]
            while stack:
                node = stack.pop()
                if node.pages:
                    groups.append(np.asarray(node.pages, np.int32))
                stack.extend(node.children.values())
            self._roots.clear()
            n = sum(int(g.size) for g in groups)
            self.pages_evicted += n
            self.pages_held -= n
        return groups

    # ----------------------------------------------------------- integrity
    def holders(self) -> Dict[int, int]:
        """Ownership multiset ``{page_id: references held}`` — what the
        pool's ``check`` adds to the block tables' counts."""
        out: Dict[int, int] = {}
        with self._lock:
            stack = [c for r in self._roots.values()
                     for c in r.children.values()]
            while stack:
                node = stack.pop()
                for p in node.pages:
                    out[p] = out.get(p, 0) + 1
                stack.extend(node.children.values())
        return out

    def check(self) -> None:
        """Trie/pool invariants: counters match the structure, every
        owned page is live at its donation epoch with refcount >= 1,
        runs are non-empty below the root, child keys match first
        digests, and parent links are consistent."""
        with self._lock:
            total = 0
            stack = [(r, None) for r in self._roots.values()]
            while stack:
                node, parent = stack.pop()
                if parent is not None:
                    assert len(node.pages) > 0, "empty non-root trie node"
                    assert node.parent is parent, "broken parent link"
                assert (len(node.pages) == len(node.digests)
                        == len(node.epochs) == len(node.generated)), \
                    "trie node arrays disagree"
                for key, child in node.children.items():
                    assert child.digests[0] == key, \
                        "child edge key != child first digest"
                    stack.append((child, node))
                if parent is not None:
                    total += len(node.pages)
                    ids = np.asarray(node.pages, np.int32)
                    assert self.pool.entry_valid(
                        ids, np.asarray(node.epochs, np.int64)), \
                        "cache-held page was recycled under the cache"
                    assert (self.pool.refcounts(ids) >= 1).all(), \
                        "cache-held page has refcount 0"
            assert total == self.pages_held, \
                (total, self.pages_held, "pages_held counter drifted")

    def stats(self) -> Dict[str, float]:
        # lookup_* are raw trie probes (a hit may still lose the
        # longest-match race or be trimmed below a chunk boundary);
        # the ENGINE's cache_hits counts adoptions that actually landed
        return {
            "cache_lookup_hits": float(self.hits),
            "cache_lookup_misses": float(self.misses),
            "cache_pages_held": float(self.pages_held),
            "cache_pages_donated": float(self.pages_donated),
            "cache_pages_duplicate": float(self.pages_duplicate),
            "cache_pages_evicted": float(self.pages_evicted),
            "cache_pages_adopted": float(self.pages_adopted),
        }
