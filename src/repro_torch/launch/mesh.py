"""The production team (counterpart of ``repro.launch.mesh``).

The reference builds a device mesh: single-pod 16 x 16 = 256 chips
(data, model), multi-pod 2 x 16 x 16 = 512 (pod, data, model), the pod
axis the outer DP axis.  The port has no mesh: its PEs are the stacked
team on one card (``core.teams``), so the same layout is a ``Team``
with those axes and sizes — built by a function, as the reference's, so
that importing this module touches no device.
"""
from __future__ import annotations

import math

from repro_torch.core.teams import Team

# (axes, sizes) of the reference's production meshes
PRODUCTION = {False: (("data", "model"), (16, 16)),
              True: (("pod", "data", "model"), (2, 16, 16))}


def make_production_team(*, multi_pod: bool = False) -> Team:
    axes, sizes = PRODUCTION[bool(multi_pod)]
    return Team(axes, sizes)


def team_name(team: Team) -> str:
    """``16x16`` / ``2x16x16``: the reference's mesh names."""
    return "x".join(str(s) for s in team.sizes)


def make_ctx(team: Team, *, backend: str = "xla", **overrides):
    """The ``ParallelCtx`` (and its tp/dp communicators) of a team whose
    last axis is ``model``, with the reference's defaults: sequence
    parallel, remat, bf16 parameters and compute.  ``tp_axis`` /
    ``dp_axes`` override which axes are TP and DP; any other keyword is
    a ``ParallelCtx`` field."""
    import torch

    from repro_torch.parallel.ctx import ParallelCtx

    sizes = dict(zip(team.axes, team.sizes))
    tp_axis = overrides.pop("tp_axis", team.axes[-1])
    dp_axes = tuple(overrides.pop("dp_axes",
                                  tuple(a for a in team.axes
                                        if a != tp_axis)))
    kw = dict(backend=backend, sp=True, remat=True,
              param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    kw.update(overrides)
    dp_size = math.prod(sizes[a] for a in dp_axes)
    if len(dp_axes) > 1 and "dp_comm" not in kw:
        # a multi-axis DP team (pod, data) names its axis sizes
        from repro_torch.comm import DispatchTable, make_communicator
        kw["dp_comm"] = make_communicator(
            Team(dp_axes, tuple(sizes[a] for a in dp_axes)), size=dp_size,
            backend=kw["backend"],
            dispatch=kw.get("dispatch") or DispatchTable(),
            name=f"dp:{kw['backend']}")
    return ParallelCtx(dp_axes=dp_axes, dp_size=dp_size,
                       tp_size=sizes[tp_axis], **kw)
