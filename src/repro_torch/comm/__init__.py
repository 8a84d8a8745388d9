"""repro_torch.comm — the collective API around the first-class
``Communicator`` (counterpart of ``repro.comm``).

A ``Communicator`` binds a team (every PE's shard on a leading axis of
one tensor), a backend from the registry ("xla" the native baseline |
"posh" the paper's put/get schedules | "pallas" the posh schedules over
the CUDA copy engine | anything added with ``register_backend``), a
``DispatchTable`` that picks each call's algorithm from (op, per-PE
payload bytes, team size), and per-op instrumentation::

    comm = make_communicator("pe", size=8, backend="pallas")
    y = comm.psum(x)                    # x: (8, *shard); algorithm by size
    g = comm.all_gather(x, axis=1)      # tiled concat, lax semantics
    comm.stats()                        # {"psum": {"calls": 1, ...}, ...}

The tree-level reductions of the reference, for the DP gradients:
``bucketing`` (per-leaf and bucketed allreduce over one bucket plan) and
``compress`` (bf16 / int8 with error feedback), also reachable as the
communicator's ``tree_psum`` / ``tree_pmean`` / ``bucketed_psum`` /
``compressed_psum``.
"""
from .communicator import (CommBackend, Communicator, DispatchTable,
                           available_backends, get_backend,
                           make_communicator, merge_candidates,
                           register_backend)
from .bucketing import (as_communicator, bucketed_allreduce, leaf_metas,
                        plan_buckets, tree_allreduce, unpack_bucket)
from .compress import CompressionState, compressed_allreduce
from .pallas_backend import PallasBackend

register_backend("pallas", PallasBackend, overwrite=True)

__all__ = [
    "Communicator", "DispatchTable", "make_communicator",
    "CommBackend", "PallasBackend",
    "register_backend", "get_backend", "available_backends",
    "merge_candidates",
    "as_communicator", "leaf_metas", "plan_buckets", "unpack_bucket",
    "tree_allreduce", "bucketed_allreduce",
    "CompressionState", "compressed_allreduce",
]
