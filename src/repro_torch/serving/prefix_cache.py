"""Cross-request KV prefix cache over the paged device pool.

The port's copy of the JAX package's ``PrefixCache``.

The paper's NVPages keeps a volatile radix index whose nodes point at
shared persistent pages; the serving twin is a token-keyed
:class:`~repro_torch.core.radix.TokenRadixTree` whose value nodes point at
refcounted read-only pages in the pooled :class:`PagedKVCache`. Admission
of a prompt whose prefix is cached becomes a **block-table splice**: the
new sequence aliases the shared physical pages (pure metadata, zero
compute, zero KV movement) and prefills only the uncovered tail. The
first write that would land inside a still-shared page triggers
copy-on-write in the engine (the writer gets a private copy; readers and
the index keep the original).

Layout: each value node covers ONE page-sized token chunk — the node at
depth ``(k+1) * page_tokens`` holds ``(phys, end_tokens)`` for logical
page ``k``. A prompt's last chunk may stop mid-page (a *boundary leaf*,
``end_tokens < (k+1) * page_tokens``); a splice may adopt it, but the
match run cannot extend past it — deeper tokens of that page belong to
the donor sequence and were never published.

Refcount protocol (the engine ↔ index contract, see
``core/engines/kv.py``):

* the index **pins** pages it references (``pin_page`` / ``unpin_page``)
  — a pinned page is never spilled out from under the index silently;
  under pool pressure the engine either asks the index to drop an idle
  entry (``reclaim_one``) or tells it a single-user page is being
  spilled (``forget_phys``);
* every live sequence that trusts a node's page holds one trie refcount
  on that node — the donor acquires at :meth:`insert`, a splicer at
  :meth:`match_and_splice` — released when the sequence stops trusting
  it: COW divergence (``on_cow``) or the sequence leaving the pool
  (``on_seq_dropped``, which fires on both release and preemption);
* eviction (capacity or ``reclaim_one``) only ever drops refcount-0
  value *leaves*, LRU-first — prefix closure means ancestors outlive
  descendants, so a dropped leaf can never strand a referenced deeper
  chunk.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.lru import LRUList
from repro_torch.core.radix import TokenRadixTree, TrieNode


class PrefixCache:
    """Radix index mapping token prefixes to shared pool pages.

    ``capacity_tokens`` bounds the tokens the index may keep pinned;
    eviction is LRU over evictable (refcount-0 leaf) entries. The engine
    must be pooled and sharing-capable (``supports_sharing()``).
    """

    def __init__(self, engine, capacity_tokens: int):
        if not engine.supports_sharing():
            raise RuntimeError(
                f"{type(engine).__name__} does not support prefix sharing "
                f"(pooled paged engines only)")
        if capacity_tokens <= 0:
            raise ValueError("capacity_tokens must be positive")
        self.engine = engine
        self.capacity_tokens = capacity_tokens
        self.page_tokens = engine.spec.page_tokens
        self._trie = TokenRadixTree()
        self._lru = LRUList()                     # nodes, identity-hashed
        self._by_phys: dict[int, TrieNode] = {}   # phys → its value node
        self._seq_nodes: dict[int, set] = {}      # seq → nodes it refs
        self._tokens = 0                          # tokens currently indexed
        engine.set_share_index(self)

    # ------------------------------------------------------------ admission
    def match_and_splice(self, seq: int, prompt: Sequence[int]) -> int:
        """Longest usable cached prefix of ``prompt``, spliced into
        ``seq``'s block table. Returns the number of covered tokens (0 on
        a miss — the caller prefills normally).

        Coverage is capped at ``len(prompt) - 1``: the admitted row still
        needs one forward pass over ≥ 1 pending token to produce its
        first logits, and that pass REWRITES the boundary slot with
        recomputed KV — identical values, since chunked prefill is pinned
        token-identical to one-shot.
        """
        toks = tuple(int(t) for t in prompt)
        if len(toks) < 2:
            return 0                  # nothing coverable under the cap
        T = self.page_tokens
        run: list[TrieNode] = []
        covered = 0
        for i, node in enumerate(self._trie.match(toks)):
            phys, end = node.value
            if (end - 1) // T != i:
                break                 # a gap: logical page i was forgotten
            run.append(node)
            covered = end
            if end != (i + 1) * T:
                break                 # boundary leaf: the run cannot extend
        covered = min(covered, len(toks) - 1)
        if covered <= 0:
            return 0
        run = run[:-(-covered // T)]
        self.engine.adopt_pages(seq, [n.value[0] for n in run], covered)
        held = self._seq_nodes.setdefault(seq, set())
        for node in run:
            self._trie.acquire(node)
            held.add(node)
            self._lru.touch(node)
        return covered

    def insert(self, seq: int, prompt: Sequence[int]) -> None:
        """Publish ``seq``'s prompt pages into the index (the donor path,
        called once the FULL prompt is prefilled). Safe no-op when the
        sequence was preempted/released meanwhile or its pages are not
        resident."""
        toks = tuple(int(t) for t in prompt)
        if not toks:
            return
        table = self.engine.block_table.get(seq)
        if not table or self.engine.seq_len.get(seq, 0) < len(toks):
            return
        T = self.page_tokens
        npages = -(-len(toks) // T)
        if npages > len(table) or any(table[k] < 0 for k in range(npages)):
            return                    # partially spilled: don't pin host pages
        held = self._seq_nodes.setdefault(seq, set())
        for k in range(npages):
            end = min((k + 1) * T, len(toks))
            phys = table[k]
            node = self._trie.find(toks[:end])
            if node is not None:
                # chunk already published; trust it only if it still names
                # OUR page (a COW'd boundary page diverged — leave the
                # original owner's entry alone)
                if node.value[0] == phys and node not in held:
                    self._trie.acquire(node)
                    held.add(node)
            else:
                if phys in self._by_phys:
                    # one page, one node: a deeper prompt re-publishing the
                    # same boundary page under a longer key would alias two
                    # entries onto one phys and corrupt forget_phys
                    continue
                node = self._trie.insert(toks[:end], (phys, end))
                self.engine.pin_page(phys)
                self._by_phys[phys] = node
                self._tokens += end - k * T
                self._trie.acquire(node)
                held.add(node)
            self._lru.touch(node)
        self._enforce_capacity()

    # ------------------------------------------------------------- eviction
    def _evict(self, node: TrieNode) -> None:
        phys, end = node.value
        self._tokens -= end - ((end - 1) // self.page_tokens) \
            * self.page_tokens
        self._trie.remove(node)
        self._lru.remove(node)
        self._by_phys.pop(phys, None)
        self.engine.unpin_page(phys)

    def _enforce_capacity(self) -> None:
        while self._tokens > self.capacity_tokens:
            victim = None
            for node in self._lru.lru_order():
                if self._trie.evictable(node):
                    victim = node
                    break
            if victim is None:
                return                # everything referenced: over-budget OK
            self._evict(victim)

    # ----------------------------------------- engine callbacks (pool side)
    def reclaim_one(self) -> Optional[int]:
        """Pool overflow: drop the LRU idle entry and return its physical
        page (now free), or None when every entry is still referenced."""
        for node in self._lru.lru_order():
            if self._trie.evictable(node):
                phys = node.value[0]
                self._evict(node)
                return phys
        return None

    def reclaimable_pages(self) -> int:
        """Upper bound on how many pool pages :meth:`reclaim_one` can free
        right now: entries no live sequence references. Refcounts are
        non-increasing with depth along any root-path (per-seq holds are
        root-contiguous runs), so every refcount-0 node eventually becomes
        an evictable leaf as shallower refcount-0 descendants are dropped —
        the count is achievable, not just a bound. The engine's headroom
        audit (``_idle_index_pages``) caps its "idle shared pages" estimate
        with this so ``can_place_step`` never promises pages the index
        cannot actually give back."""
        return sum(1 for node in self._by_phys.values() if node.refs == 0)

    def forget_phys(self, phys: int) -> None:
        """The engine is spilling/retiring this page: drop its entry. The
        page's sole live user keeps its data (the spill blob); future
        prompts simply miss."""
        node = self._by_phys.pop(phys, None)
        if node is None:
            return
        _, end = node.value
        self._tokens -= end - ((end - 1) // self.page_tokens) \
            * self.page_tokens
        self._trie.remove(node)
        self._lru.remove(node)
        self.engine.unpin_page(phys)

    def on_cow(self, seq: int, phys: int) -> None:
        """``seq`` diverged from the shared page at ``phys`` (it now writes
        a private copy): it stops referencing that node."""
        node = self._by_phys.get(phys)
        held = self._seq_nodes.get(seq)
        if node is not None and held is not None and node in held:
            held.discard(node)
            self._trie.release(node)

    def on_seq_dropped(self, seq: int) -> None:
        """``seq`` left the pool (release or preemption): release every
        node it referenced."""
        for node in self._seq_nodes.pop(seq, ()):
            self._trie.release(node)

    # --------------------------------------------------------------- views
    def __len__(self) -> int:
        return len(self._trie)

    @property
    def indexed_tokens(self) -> int:
        return self._tokens
