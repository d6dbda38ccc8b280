"""O(1) LRU list (doubly-linked) for page-frame eviction policies."""
from __future__ import annotations

from typing import Any, Iterator, Optional


class _Node:
    __slots__ = ("key", "prev", "next")

    def __init__(self, key):
        self.key = key
        self.prev: Optional["_Node"] = None
        self.next: Optional["_Node"] = None


class LRUList:
    """Tracks recency. ``touch`` moves to MRU; ``pop_lru`` evicts the LRU key."""

    def __init__(self):
        self._map: dict[Any, _Node] = {}
        self._head: Optional[_Node] = None   # MRU
        self._tail: Optional[_Node] = None   # LRU

    def __len__(self):
        return len(self._map)

    def __contains__(self, key):
        return key in self._map

    def _unlink(self, node: _Node):
        if node.prev:
            node.prev.next = node.next
        else:
            self._head = node.next
        if node.next:
            node.next.prev = node.prev
        else:
            self._tail = node.prev
        node.prev = node.next = None

    def _push_front(self, node: _Node):
        node.next = self._head
        if self._head:
            self._head.prev = node
        self._head = node
        if self._tail is None:
            self._tail = node

    def touch(self, key) -> None:
        node = self._map.get(key)
        if node is None:
            node = _Node(key)
            self._map[key] = node
        else:
            self._unlink(node)
        self._push_front(node)

    def remove(self, key) -> None:
        node = self._map.pop(key, None)
        if node is not None:
            self._unlink(node)

    def pop_lru(self):
        if self._tail is None:
            return None
        key = self._tail.key
        self.remove(key)
        return key

    def lru_order(self) -> Iterator[Any]:
        node = self._tail
        while node is not None:
            yield node.key
            node = node.prev
