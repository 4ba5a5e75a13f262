"""Bounded FIFO with raising and non-raising operations.

Copy of the JAX package's ``sim/bounded_queue.py``: the reference
StencilFlow's BoundedQueue contract, mirrored exactly — including its
queue layout: ``enqueue`` appends on the LEFT, ``dequeue``
pops on the RIGHT, so ``peek(i)`` indexes from the newest end,
``try_peek_last`` returns the next element to be dequeued,
``import_data(data)`` yields dequeue order ``data[-1], ..., data[0]``, and
``export_data`` lists elements in dequeue order.  ``enqueue``/``dequeue``
raise on overflow/underflow (the mechanism by which simulation proves
buffer bounds); ``try_*`` variants return False instead (the reference's
convention); ``swap_out`` is the marker the memory optimizer flips when a
buffer is spilled to slow memory.
"""
from __future__ import annotations

from collections import deque
from typing import Any, List, Sequence


class QueueOverflow(RuntimeError):
    pass


class QueueUnderflow(RuntimeError):
    pass


class BoundedQueue:
    def __init__(self, name: str, maxsize: int,
                 collection: Sequence[Any] = ()):
        if maxsize < 1:
            maxsize = 1  # reference clamps to >= 1 (bounded_queue.py:41)
        self.name = name
        self.maxsize = maxsize
        self.queue: deque = deque()
        self.swap_out = False  # set by the optimizer: lives in slow memory
        self.import_data(collection)

    # -- size ----------------------------------------------------------------
    def size(self) -> int:
        return len(self.queue)

    def is_empty(self) -> bool:
        return not self.queue

    def is_full(self) -> bool:
        return len(self.queue) >= self.maxsize

    # -- bulk ----------------------------------------------------------------
    def import_data(self, collection: Sequence[Any]) -> None:
        data = list(collection)
        if len(data) > self.maxsize:
            raise QueueOverflow(
                f"{self.name}: import of {len(data)} items exceeds "
                f"maxsize {self.maxsize}")
        # reference: deque(data) with dequeue from the right — data[-1]
        # leaves first (bounded_queue.py import_data)
        self.queue = deque(data)

    def export_data(self) -> List[Any]:
        """Elements in dequeue order (reference: np.array(queue)[::-1])."""
        return list(self.queue)[::-1]

    # -- raising ops ---------------------------------------------------------
    def enqueue(self, item: Any) -> None:
        if self.is_full():
            raise QueueOverflow(
                f"{self.name}: enqueue on full queue (maxsize "
                f"{self.maxsize}) — buffer size assumption violated")
        self.queue.appendleft(item)

    def dequeue(self) -> Any:
        if not self.queue:
            raise QueueUnderflow(f"{self.name}: dequeue on empty queue")
        return self.queue.pop()

    # -- non-raising ops -----------------------------------------------------
    def try_enqueue(self, item: Any) -> bool:
        if self.is_full():
            return False
        self.queue.appendleft(item)
        return True

    def try_dequeue(self) -> Any:
        return self.queue.pop() if self.queue else False

    def peek(self, index: int) -> Any:
        """Item at ``index`` counted from the NEWEST end (the reference's
        indexing); raises on out-of-range."""
        if index >= len(self.queue):
            raise QueueUnderflow(
                f"{self.name}: peek({index}) with size {self.size()}")
        return self.queue[index]

    def try_peek_last(self) -> Any:
        """Next element to be dequeued, or False when empty."""
        return self.queue[-1] if self.queue else False
