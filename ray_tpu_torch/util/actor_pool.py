"""ActorPool: fan work out over a fixed set of actors, harvesting results
in submission order or completion order (own copy of
ray_tpu.util.actor_pool).

Reference capability: python/ray/util/actor_pool.py (same public API; the
bookkeeping here is sequence-number based — each dispatched call gets a
monotonically increasing ticket, and ordered consumption walks the ticket
counter past any entries already taken by unordered consumption).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, Tuple, TypeVar

from ray_tpu_torch import api
from ray_tpu_torch.core.object_ref import ObjectRef

V = TypeVar("V")


@dataclass
class _Ticket:
    seq: int
    actor: Any
    ref: ObjectRef


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._free: Deque[Any] = deque(actors)
        self._backlog: Deque[Tuple[Callable, Any]] = deque()
        self._tickets: Dict[int, _Ticket] = {}  # seq -> in-flight call
        self._seq_of: Dict[ObjectRef, int] = {}
        self._issued = 0  # next ticket number to assign
        self._cursor = 0  # next ticket get_next() emits

    def submit(self, fn: Callable[[Any, V], ObjectRef], value: V) -> None:
        """fn(actor, value) -> ObjectRef. Queued if every actor is busy."""
        if not self._free:
            self._backlog.append((fn, value))
            return
        actor = self._free.popleft()
        ticket = _Ticket(self._issued, actor, fn(actor, value))
        self._issued += 1
        self._tickets[ticket.seq] = ticket
        self._seq_of[ticket.ref] = ticket.seq

    def has_next(self) -> bool:
        return bool(self._tickets or self._backlog)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in SUBMISSION order."""
        if not self.has_next():
            raise StopIteration("No more results to get")
        while self._cursor not in self._tickets and self._cursor < self._issued:
            self._cursor += 1  # skip tickets consumed by get_next_unordered
        ticket = self._tickets[self._cursor]
        # get() first: on timeout the cursor must NOT advance, so a retry can
        # still collect this result and return the actor
        value = api.get(ticket.ref, timeout=timeout)
        self._cursor += 1
        self._retire(ticket)
        return value

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Whichever pending result completes first."""
        if not self.has_next():
            raise StopIteration("No more results to get")
        ready, _ = api.wait(
            [t.ref for t in self._tickets.values()], num_returns=1, timeout=timeout
        )
        if not ready:
            raise TimeoutError("Timed out waiting for result")
        ticket = self._tickets[self._seq_of[ready[0]]]
        value = api.get(ticket.ref)
        self._retire(ticket)
        return value

    def _retire(self, ticket: _Ticket) -> None:
        del self._tickets[ticket.seq]
        del self._seq_of[ticket.ref]
        self._free.append(ticket.actor)
        self._drain_backlog()

    def _drain_backlog(self) -> None:
        while self._backlog and self._free:
            fn, value = self._backlog.popleft()
            self.submit(fn, value)

    def map(self, fn: Callable, values: Iterable[V]) -> Iterable[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[V]) -> Iterable[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def has_free(self) -> bool:
        return bool(self._free)

    def pop_idle(self) -> Optional[Any]:
        return self._free.pop() if self._free else None

    def push(self, actor: Any) -> None:
        self._free.append(actor)
        self._drain_backlog()
