"""Process sets: collectives over subgroups of the ranks.

The counterpart of ``horovod_tpu/parallel/process_sets.py`` (the
reference's ``ProcessSet``/``ProcessSetTable``, common/process_sets.py).
A process set is a sorted list of ranks, id 0 being the global set. Its
collectives run on a process group over its members, which
:func:`add_process_set` creates on every rank, members or not, as
Horovod's torch API requires (``dist.new_group`` is collective), and warms
on its members. Every rank must therefore register the same sets in the
same order.

``axis_index_groups()`` is the JAX package's table: the member group
followed by a singleton group for each other rank, which is what every
rank of the port computes with (members reduce with each other,
non-members with themselves).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence


class ProcessSet:
    """A subgroup of ranks (reference common/process_sets.py:18)."""

    def __init__(self, ranks: Optional[Sequence[int]] = None):
        self.ranks: Optional[List[int]] = (
            sorted(int(r) for r in ranks) if ranks is not None else None)
        self.process_set_id: Optional[int] = None
        self._table: Optional["ProcessSetTable"] = None

    def size(self) -> int:
        self._check_registered()
        if self.process_set_id == 0:
            return self._table.world_size
        return len(self.ranks)

    def rank(self) -> int:
        """This rank's index within the set, -1 when it is not a member."""
        self._check_registered()
        me = self._table.context.rank
        if self.process_set_id == 0:
            return me
        try:
            return self.ranks.index(me)
        except ValueError:
            return -1

    def included(self) -> bool:
        return self.rank() >= 0

    def axis_index_groups(self) -> Optional[List[List[int]]]:
        """None for the global set; else the member group, then one
        singleton group per non-member rank."""
        self._check_registered()
        if self.process_set_id == 0:
            return None
        member = set(self.ranks)
        groups = [list(self.ranks)]
        groups.extend([r] for r in range(self._table.world_size)
                      if r not in member)
        return groups

    def _check_registered(self):
        if self._table is None or self.process_set_id is None:
            raise ValueError(
                "ProcessSet is not registered; pass it to "
                "horovod_tpu_torch.add_process_set() first.")

    def __repr__(self):
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"

    def __eq__(self, other):
        return (isinstance(other, ProcessSet)
                and self.process_set_id == other.process_set_id)

    def __hash__(self):
        return hash(("ProcessSet", self.process_set_id))


class ProcessSetTable:
    """Registry id -> ProcessSet (reference common/process_set.h:89)."""

    def __init__(self, context):
        self.context = context
        self.world_size = context.size
        self._lock = threading.Lock()
        self._by_id: Dict[int, ProcessSet] = {}
        self._next_id = 1

    def add(self, ps: ProcessSet) -> ProcessSet:
        with self._lock:
            if ps.ranks is None:
                raise ValueError("ProcessSet needs explicit ranks")
            if not ps.ranks:
                raise ValueError("ProcessSet may not be empty")
            if ps.ranks[0] < 0 or ps.ranks[-1] >= self.world_size:
                raise ValueError(
                    f"ranks {ps.ranks} out of range for world size "
                    f"{self.world_size}")
            if len(set(ps.ranks)) != len(ps.ranks):
                raise ValueError("duplicate ranks in ProcessSet")
            for existing in self._by_id.values():
                if existing.process_set_id != 0 and existing.ranks == ps.ranks:
                    raise ValueError(
                        f"A process set with ranks {ps.ranks} already exists "
                        f"(id {existing.process_set_id})")
            # collective on every rank; raises if the group fails to form
            self.context.ensure_partition([ps.ranks])
            ps.process_set_id = self._next_id
            self._next_id += 1
            ps._table = self
            self._by_id[ps.process_set_id] = ps
            return ps

    def remove(self, ps: ProcessSet) -> None:
        with self._lock:
            if ps.process_set_id in (None, 0):
                raise ValueError("Cannot remove the global process set")
            self._by_id.pop(ps.process_set_id, None)
            ps.process_set_id = None

    def get(self, process_set_id: int) -> ProcessSet:
        with self._lock:
            if process_set_id not in self._by_id:
                raise ValueError(f"unknown process set id {process_set_id}")
            return self._by_id[process_set_id]

    def ids(self) -> List[int]:
        with self._lock:
            return sorted(self._by_id)

    def all_sets(self) -> List[ProcessSet]:
        """Registered sets in id order."""
        with self._lock:
            return [self._by_id[i] for i in sorted(self._by_id)]


# The global set (id 0), usable before init like the reference's
# ``hvd.process_sets.global_process_set``.
global_process_set = ProcessSet()
global_process_set.process_set_id = 0


def _attach(context) -> None:
    """Called by ``runtime.context.init``: the table and the global set."""
    table = ProcessSetTable(context)
    context.process_set_table = table
    global_process_set._table = table
    global_process_set.ranks = list(range(table.world_size))
    table._by_id[0] = global_process_set


def _table() -> ProcessSetTable:
    from horovod_tpu_torch.runtime.context import get_context
    return get_context().process_set_table


def add_process_set(ranks_or_ps) -> ProcessSet:
    """Register a new process set on every rank (reference
    process_sets.py:123); every rank must call it with the same ranks."""
    ps = (ranks_or_ps if isinstance(ranks_or_ps, ProcessSet)
          else ProcessSet(ranks_or_ps))
    return _table().add(ps)


def remove_process_set(ps: ProcessSet) -> None:
    _table().remove(ps)


def get_process_set_by_id(process_set_id: int) -> ProcessSet:
    return _table().get(process_set_id)


def process_set_ids() -> List[int]:
    return _table().ids()
