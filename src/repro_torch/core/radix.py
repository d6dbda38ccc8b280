"""Token-sequence radix trie: the shared-prefix index.

The port's copy of the JAX package's ``TokenRadixTree`` and of NVPages'
int-keyed ``RadixTree``. A token-keyed prefix trie with longest-prefix
match, insert-along-path and per-node refcounts; the serving tier's prefix
cache hangs refcounted pool pages off its value nodes. NVPages indexes its
frames through :class:`RadixTree`, a thin wrapper that maps a page number
to its 4 radix bytes (the paper's "radix tree in volatile memory").

Invariants the prefix cache relies on:

* a *value node* marks the end of one page-sized token chunk (the last
  chunk of a prompt may be shorter than a page — a boundary leaf);
* ``match`` walks token by token and returns every value node it passes,
  shallowest first — the longest shared prefix is the deepest one;
* refcounts live on value nodes; because a sequence that acquires a deep
  node also acquires every ancestor value node on its path (prefix
  closure), ancestor refcounts always dominate descendants', so evicting
  refcount-0 value *leaves* (``subtree_values == 1``) can never strand a
  referenced descendant.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional, Sequence


class TrieNode:
    __slots__ = ("token", "parent", "children", "value", "has_value",
                 "refs", "subtree_values")

    def __init__(self, token: Any = None,
                 parent: Optional["TrieNode"] = None):
        self.token = token
        self.parent = parent
        self.children: dict = {}
        self.value: Any = None
        self.has_value = False
        self.refs = 0                 # sequences currently aliasing this node
        self.subtree_values = 0       # value nodes in this subtree (incl self)


class TokenRadixTree:
    """Prefix trie over token sequences with per-node refcounts."""

    __slots__ = ("_root", "_values")

    def __init__(self):
        self._root = TrieNode()
        self._values = 0

    # ------------------------------------------------------------- walking
    def _walk(self, tokens: Sequence) -> Optional[TrieNode]:
        node = self._root
        for t in tokens:
            node = node.children.get(t)
            if node is None:
                return None
        return node

    def match(self, tokens: Sequence) -> list[TrieNode]:
        """Longest-prefix match: every value node on the deepest walkable
        path, shallowest first (each marks one fully covered chunk)."""
        node, out = self._root, []
        for t in tokens:
            node = node.children.get(t)
            if node is None:
                break
            if node.has_value:
                out.append(node)
        return out

    def lookup(self, tokens: Sequence) -> Optional[Any]:
        """Exact-key lookup (None when no value ends exactly here)."""
        node = self._walk(tokens)
        return node.value if node is not None and node.has_value else None

    def find(self, tokens: Sequence) -> Optional[TrieNode]:
        """The value node ending exactly at ``tokens`` (None otherwise)."""
        node = self._walk(tokens)
        return node if node is not None and node.has_value else None

    # ----------------------------------------------------------- mutation
    def insert(self, tokens: Sequence, value: Any) -> TrieNode:
        """Insert along the path, set ``value`` at the final node."""
        node = self._root
        for t in tokens:
            child = node.children.get(t)
            if child is None:
                child = TrieNode(t, node)
                node.children[t] = child
            node = child
        if not node.has_value:
            node.has_value = True
            self._values += 1
            p: Optional[TrieNode] = node
            while p is not None:
                p.subtree_values += 1
                p = p.parent
        node.value = value
        return node

    def remove(self, node: TrieNode) -> None:
        """Clear the value at ``node`` and prune any now-empty chain."""
        if not node.has_value:
            return
        node.has_value = False
        node.value = None
        self._values -= 1
        p: Optional[TrieNode] = node
        while p is not None:
            p.subtree_values -= 1
            p = p.parent
        while (node.parent is not None and not node.children
               and not node.has_value):
            parent = node.parent
            del parent.children[node.token]
            node = parent

    def delete(self, tokens: Sequence) -> None:
        node = self._walk(tokens)
        if node is not None:
            self.remove(node)

    # ---------------------------------------------------------- refcounts
    def acquire(self, node: TrieNode) -> None:
        node.refs += 1

    def release(self, node: TrieNode) -> None:
        if node.refs <= 0:
            raise RuntimeError("radix node refcount underflow")
        node.refs -= 1

    def evictable(self, node: TrieNode) -> bool:
        """A value leaf no live sequence references: safe to drop. Interior
        value nodes wait for their subtrees to empty (prefix closure)."""
        return node.has_value and node.refs == 0 and node.subtree_values == 1

    # -------------------------------------------------------------- views
    def __len__(self) -> int:
        return self._values

    def items(self) -> Iterator[tuple[tuple, Any]]:
        def walk(node: TrieNode, prefix: tuple):
            if node.has_value:
                yield prefix, node.value
            for t, child in node.children.items():
                yield from walk(child, prefix + (t,))
        yield from walk(self._root, ())


# --------------------------------------------------------------------------
# NVPages' int-keyed page index, a wrapper over the token trie
# --------------------------------------------------------------------------

_LEVELS = 4
_FANOUT = 256
_SHIFTS = [(8 * (_LEVELS - 1 - i)) for i in range(_LEVELS)]   # 24,16,8,0
_MAX_KEY = _FANOUT ** _LEVELS


class RadixTree:
    """4-level 256-ary radix tree: page number → metadata (NVPages)."""

    __slots__ = ("_trie",)

    def __init__(self):
        self._trie = TokenRadixTree()

    def _indices(self, key: int) -> list[int]:
        if not (0 <= key < _MAX_KEY):
            raise KeyError(f"key {key} out of radix range")
        return [(key >> s) & 0xFF for s in _SHIFTS]

    def lookup(self, key: int) -> Optional[Any]:
        return self._trie.lookup(self._indices(key))

    def insert(self, key: int, value: Any) -> None:
        self._trie.insert(self._indices(key), value)

    def delete(self, key: int) -> None:
        self._trie.delete(self._indices(key))

    def __len__(self) -> int:
        return self._trie._values

    def items(self) -> Iterator[tuple[int, Any]]:
        for bytes_, value in self._trie.items():
            key = 0
            for b, s in zip(bytes_, _SHIFTS):
                key |= b << s
            yield key, value
