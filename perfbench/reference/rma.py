"""The plain reference of the put/get rounds: what OpenSHMEM's
semantics deliver.  After round ``r``'s quiet, PE i's copy of block k
holds what PE i - 1 put there (pattern ``plan.pattern(r, k)``'s row
i - 1), and PE i's get of block k returns PE i - 1's copy: the row of PE
i - 2.  ``patterns`` makes the round payloads from the seed, on the
device, in a few large calls."""
from __future__ import annotations

import torch

from perfbench.lib import weights


def patterns(seed: int, n: int, n_pe: int, elems: int, dtype,
             device) -> list:
    """``n`` payloads (n_pe, elems): normal values for a float dtype,
    uniform int32 otherwise."""
    g = torch.Generator(device=device)
    out = []
    for i in range(n):
        g.manual_seed(weights.stream_seed(seed, f"rma{i}"))
        if dtype.is_floating_point:
            out.append(torch.randn((n_pe, elems), generator=g, dtype=dtype,
                                   device=device))
        else:
            out.append(torch.randint(-2 ** 31, 2 ** 31 - 1, (n_pe, elems),
                                     generator=g, dtype=dtype, device=device))
    return out


def expected(pats: list, plan, r: int, k: int):
    """(block k on every PE, every PE's get of block k) after round r."""
    p = pats[plan.pattern(r, k)]
    return torch.roll(p, 1, 0), torch.roll(p, 2, 0)


def mismatches(pats: list, plan, r: int, blocks: list, values: list) -> int:
    """Elements of round r's delivered blocks and fetched values that
    differ from what the semantics deliver."""
    bad = 0
    for k, (blk, val) in enumerate(zip(blocks, values)):
        want_blk, want_val = expected(pats, plan, r, k)
        bad += int((blk != want_blk).sum()) + int((val != want_val).sum())
    return bad
