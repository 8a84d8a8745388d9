"""Teams and active sets — the PE-addressing layer (counterpart of
``repro.core.teams``).

In POSH a PE is an OS process, and OpenSHMEM 1.0 collectives address
subsets of the PEs through ``(PE_start, logPE_stride, PE_size)`` active
sets.  The reference makes a PE a mesh device and a *team* an ordered
tuple of mesh axis names whose flattened product is the PE numbering.

The port runs every PE of a team in one process on one card: the
system state is ONE tensor with the team's PE axis first, ``(n_pe,
*shard)`` — POSH's own setting, one shared-memory node where every PE
maps every other PE's heap.  So a :class:`Team` carries its axis sizes
explicitly (the reference asks the mesh), a multi-axis team flattens
row-major into that leading axis, and ``my_pe`` is simply
``arange(n_pe)``: every per-PE quantity the reference traces is known on
the host here, which is what lets the schedules in ``collectives`` turn
per-PE indices into index tensors built once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import torch

from ..device import resolve

TeamAxes = Union[str, Sequence[str], "Team"]


def _canon(team) -> tuple[str, ...]:
    if isinstance(team, str):
        return (team,)
    return tuple(team)


@dataclasses.dataclass(frozen=True)
class ActiveSet:
    """OpenSHMEM 1.0 active set: PEs ``start + i * 2**log2_stride``.

    ``size == 0`` means "the whole team" (resolved against the team size
    at schedule-construction time).
    """

    start: int = 0
    log2_stride: int = 0
    size: int = 0

    def resolve(self, team_size: int) -> "ActiveSet":
        size = self.size
        stride = 1 << self.log2_stride
        if size == 0:
            size = (team_size - self.start + stride - 1) // stride
        last = self.start + (size - 1) * stride
        if not (0 <= self.start and last < team_size):
            raise ValueError(
                f"active set {self} does not fit in team of {team_size} PEs"
            )
        return ActiveSet(self.start, self.log2_stride, size)

    def pe(self, virtual_rank: int) -> int:
        """Physical PE id of a virtual rank inside the set (static)."""
        return self.start + virtual_rank * (1 << self.log2_stride)

    def pes(self) -> list[int]:
        return [self.pe(v) for v in range(self.size)]


@dataclasses.dataclass(frozen=True)
class Team:
    """An ordered set of axes addressed as one flat PE space, with the
    static size of each axis (row-major flattening)."""

    axes: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axes) != len(self.sizes):
            raise ValueError(f"team axes {self.axes} and sizes {self.sizes} "
                             "differ in length")
        if any(int(s) < 1 for s in self.sizes):
            raise ValueError(f"team sizes must be >= 1, got {self.sizes}")

    @classmethod
    def of(cls, team: TeamAxes, size: Union[int, Sequence[int], None] = None
           ) -> "Team":
        """A Team from a Team, an axis name or a tuple of them.  ``size``
        is the PE count (one axis) or the per-axis sizes; for a Team it
        is checked against the team's own size."""
        if isinstance(team, Team):
            if size is not None and _total(size) != team.size():
                raise ValueError(f"team {team} has {team.size()} PEs, "
                                 f"the data has {_total(size)}")
            return team
        axes = _canon(team)
        if size is None:
            raise ValueError(f"team {axes}: the PE count is needed (the "
                             "port keeps every PE on a leading tensor axis)")
        if hasattr(size, "__index__"):         # one int: a one-axis team
            if len(axes) != 1:
                raise ValueError(f"multi-axis team {axes}: give one size "
                                 "per axis, or a Team")
            sizes = (int(size),)
        else:
            sizes = tuple(int(s) for s in size)
        return cls(axes, sizes)

    def size(self) -> int:
        """Number of PEs in the team (static int)."""
        return math.prod(self.sizes)

    def my_pe(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """Every PE's rank in the flattened team, along the PE axis, on
        ``device`` (the card unless the CPU is asked for)."""
        return torch.arange(self.size(), dtype=torch.int32,
                            device=resolve(device))

    @property
    def axis_name(self):
        return self.axes if len(self.axes) > 1 else self.axes[0]


def _total(size) -> int:
    if hasattr(size, "__index__"):
        return int(size)
    return math.prod(int(s) for s in size)


def team_size(team: TeamAxes, size=None) -> int:
    return Team.of(team, size).size()


def my_pe(team: TeamAxes, size=None, device=None) -> torch.Tensor:
    return Team.of(team, size).my_pe(device)
