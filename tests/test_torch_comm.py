"""repro_torch's collectives and communicator against the JAX reference
on 8 PEs.

The reference runs its collectives inside ``shard_map`` over 8 CPU
devices, which must be set before JAX starts; so this file re-executes
itself in a subprocess (``--jax-worker``) with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, and the pytest
process keeps one device.  The worker runs a fixed case list on seeded
numpy inputs and writes inputs, outputs and ``stats()`` to an ``.npz``;
each test runs one case through the port on the CPU — the stacked
``(8, *shard)`` tensor that the reference's 8 shards make — and
compares.

Cases: every collective x every algorithm; partial active sets (a
non-power-of-two set, a strided power-of-two set) and non-zero roots;
sum/prod/max/min; f32 and bf16; per-PE sizes on both sides of both
dispatch thresholds (16 KiB psum, 32 KiB all_gather) and of the copy
engine's 4 KiB "stock" threshold, not divisible by 8; the communicator
under xla/posh/pallas for psum, pmax, pmean, all_gather (tiled and
stacked, two axes), psum_scatter, all_to_all, pbroadcast and
top_k_merge, with ``stats()`` equal; the heap-bound ring (Lemma 1:
the heap's fingerprint unchanged); the owner-computes atomics
(fadd/swap/cswap, ``TicketLock``) with partial participation and active
sets, exactly.

Tolerances: the port's posh and pallas results must equal the
reference's posh results BIT FOR BIT (same schedules, same combine
order per PE; the copy engine is an identity).  The ``xla`` rows are
one PyTorch reduction against XLA's all-reduce, which sums in its own
order: f32 within rtol 1e-6 (plus an atol of 1e-6 x the largest input
magnitude x 8 for cancellation), bf16 within one bf16 ulp of the
reference value.  The reference's own pallas rows (few: the Pallas
kernel runs in interpret mode) must equal its posh rows bit for bit.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8

# ----------------------------------------------------------------------
# inputs (seeded numpy; bf16 inputs are f32 values cast on each side)
# ----------------------------------------------------------------------
SHAPES = {
    "small": (37,),            # 148 B: eager everywhere, stock staging
    "tree": (4090,),           # 16360 B: psum eager (tree), kernel staging
    "ring_stock": (4100,),     # 16400 B: psum ring, 2052 B chunks (stock)
    "ring": (8200,),           # 32800 B: psum ring, 4100 B chunks (kernel)
    "ag_rd": (8190,),          # 32760 B: all_gather recursive doubling
    "ag_ring": (8195,),        # 32780 B: all_gather ring
    "mat": (16, 3),            # reduce_scatter / psum_scatter / all_to_all
    "tam": (3, 16),
    "a2a": (8, 5),             # alltoall: leading dim = team size
    "a2a4": (4, 5),            # alltoall over a 4-PE active set
}
BF16 = ("small", "ring")


def make_inputs():
    rng = np.random.RandomState(1234)
    xs = {k: rng.randn(N, *s).astype(np.float32) for k, s in SHAPES.items()}
    for k in BF16:
        xs[k + "_bf16"] = rng.randn(N, *SHAPES[k]).astype(np.float32)
    # top-k candidates: per PE 2 rows of 4 values, descending, with ties
    # across PEs; global indices distinct per row
    v = np.sort(rng.randint(0, 6, size=(N, 2, 4)).astype(np.float32),
                axis=-1)[..., ::-1].copy()
    idx = (np.arange(N)[:, None, None] * 4 + np.arange(4)[None, None, :]
           + np.zeros((1, 2, 1), np.int64)).astype(np.int32)
    xs["topk_v"], xs["topk_i"] = v, idx
    # counter words for the owner-computes atomics (small, so cswap hits)
    xs["ctr"] = rng.randint(0, 5, size=(N, 4)).astype(np.int32)
    return xs


ASETS = {"full": None, "odd3": (1, 1, 3), "even4": (0, 1, 4)}

# (case id, input key, kind, params)
CORE = []
for _op in ("sum", "prod", "max", "min"):
    for _algo in ("ring", "tree", "recursive_doubling", "xla"):
        CORE.append((f"allreduce-{_algo}-{_op}", "small", "allreduce",
                     dict(op=_op, algo=_algo)))
for _algo in ("ring", "tree", "recursive_doubling", "xla"):
    CORE.append((f"allreduce-{_algo}-sum-bf16", "small_bf16", "allreduce",
                 dict(op="sum", algo=_algo)))
    CORE.append((f"allreduce-{_algo}-max-bf16", "ring_bf16", "allreduce",
                 dict(op="max", algo=_algo)))
CORE.append(("allreduce-ring-sum-f32-large", "ring", "allreduce",
             dict(op="sum", algo="ring")))
for _aset in ("odd3", "even4"):
    for _algo in ("ring", "tree", "recursive_doubling"):
        CORE.append((f"allreduce-{_algo}-sum-{_aset}", "small", "allreduce",
                     dict(op="sum", algo=_algo, aset=_aset)))
for _algo in ("binomial", "binomial_pull", "linear", "xla"):
    CORE.append((f"broadcast-{_algo}-root3", "small", "broadcast",
                 dict(root=3, algo=_algo)))
    CORE.append((f"broadcast-{_algo}-root1-odd3", "small", "broadcast",
                 dict(root=1, algo=_algo, aset="odd3")))
CORE.append(("broadcast-binomial-root5-bf16", "small_bf16", "broadcast",
             dict(root=5, algo="binomial")))
for _algo in ("ring", "ring_pull", "recursive_doubling", "xla"):
    CORE.append((f"fcollect-{_algo}", "small", "fcollect", dict(algo=_algo)))
for _algo in ("ring", "ring_pull", "recursive_doubling"):
    CORE.append((f"fcollect-{_algo}-even4", "small", "fcollect",
                 dict(algo=_algo, aset="even4")))
CORE.append(("fcollect-recursive_doubling-odd3", "small", "fcollect",
             dict(algo="recursive_doubling", aset="odd3")))
CORE.append(("reduce-sum-root2", "small", "reduce", dict(root=2, op="sum")))
CORE.append(("reduce-max-root1-odd3", "small", "reduce",
             dict(root=1, op="max", aset="odd3")))
for _algo in ("ring", "xla"):
    CORE.append((f"reduce_scatter-{_algo}-sum", "mat", "reduce_scatter",
                 dict(op="sum", algo=_algo)))
CORE.append(("reduce_scatter-ring-prod", "mat", "reduce_scatter",
             dict(op="prod", algo="ring")))
CORE.append(("reduce_scatter-ring-sum-even4", "mat", "reduce_scatter",
             dict(op="sum", algo="ring", aset="even4")))
for _algo in ("pairwise", "xla"):
    CORE.append((f"alltoall-{_algo}", "a2a", "alltoall", dict(algo=_algo)))
CORE.append(("alltoall-pairwise-even4", "a2a4", "alltoall",
             dict(algo="pairwise", aset="even4")))
CORE.append(("barrier-full", "small", "barrier", {}))
CORE.append(("barrier-odd3", "small", "barrier", dict(aset="odd3")))

# communicator cases: (method, kwargs, input key)
COMM = [
    ("psum", {}, "small"), ("psum", {}, "tree"), ("psum", {}, "ring_stock"),
    ("psum", {}, "ring"), ("psum", {}, "small_bf16"),
    ("psum", {}, "ring_bf16"),
    ("pmax", {}, "small"), ("pmean", {}, "tree"),
    ("all_gather", dict(axis=0), "small"),
    ("all_gather", dict(axis=0), "ag_rd"),
    ("all_gather", dict(axis=0), "ag_ring"),
    ("all_gather", dict(axis=1), "mat"),
    ("all_gather", dict(axis=1, tiled=False), "mat"),
    ("psum_scatter", dict(axis=0), "mat"),
    ("psum_scatter", dict(axis=1), "tam"),
    ("all_to_all", dict(split_axis=0, concat_axis=1), "mat"),
    ("all_to_all", dict(split_axis=1, concat_axis=0), "tam"),
    ("pbroadcast", dict(root=3), "small"),
    ("pbroadcast", dict(root=5), "small_bf16"),
    ("top_k_merge", dict(k=5), "topk"),
]
BACKENDS = ("xla", "posh", "pallas")

# owner-computes atomics on word 2 of each PE's 4-word counter: PE r
# participates iff r % 3 != 1, adds/writes r + 1, cswap's cond is
# 2r mod 5; (case id, kind, owner, active set)
ATOMICS = [("fadd-owner2", "fadd", 2, "full"),
           ("fadd-owner1-odd3", "fadd", 1, "odd3"),
           ("swap-owner0", "swap", 0, "full"),
           ("swap-owner2-even4", "swap", 2, "even4"),
           ("cswap-owner3", "cswap", 3, "full"),
           ("cswap-owner1-even4", "cswap", 1, "even4"),
           ("ticket", "ticket", 0, "full"),
           ("ticket-odd3", "ticket", 0, "odd3")]


def _comm_id(method, kw, key):
    extra = "".join(f"-{k}{v}" for k, v in sorted(kw.items()))
    return f"{method}{extra}-{key}"


# the reference's pallas rows (Pallas in interpret mode: a few only)
JAX_PALLAS = [("psum", {}, "tree"), ("all_gather", dict(axis=0), "ag_rd")]
HEAP_CASE = ("psum", {}, "ring")


# ======================================================================
# the JAX side (subprocess)
# ======================================================================
def _jax_worker(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import comm as C
    from repro import compat
    from repro import core as posh

    mesh = compat.make_mesh((N,), ("pe",))
    xs = make_inputs()
    out = {f"in:{k}": v for k, v in xs.items()}

    def jin(key):
        a = jnp.asarray(xs[key])
        return a.astype(jnp.bfloat16) if key.endswith("_bf16") else a

    def run(body, key):
        def per_pe(v):
            return body(v[0])[None]
        fn = jax.jit(compat.shard_map(per_pe, mesh=mesh, in_specs=P("pe"),
                                      out_specs=P("pe"), check_vma=False))
        return np.asarray(fn(jin(key)).astype(jnp.float32)
                          if key.endswith("_bf16") else fn(jin(key)))

    def aset_of(p):
        a = ASETS[p.get("aset", "full")]
        return None if a is None else posh.ActiveSet(*a)

    for cid, key, kind, p in CORE:
        aset = aset_of(p)
        if kind == "allreduce":
            body = lambda v, p=p, a=aset: posh.allreduce(
                v, p["op"], "pe", p["algo"], active_set=a)
        elif kind == "broadcast":
            body = lambda v, p=p, a=aset: posh.broadcast(
                v, p["root"], "pe", p["algo"], active_set=a)
        elif kind == "fcollect":
            body = lambda v, p=p, a=aset: posh.fcollect(
                v, "pe", p["algo"], active_set=a)
        elif kind == "reduce":
            body = lambda v, p=p, a=aset: posh.reduce(
                v, p["root"], p["op"], "pe", active_set=a)
        elif kind == "reduce_scatter":
            body = lambda v, p=p, a=aset: posh.reduce_scatter(
                v, p["op"], "pe", p["algo"], active_set=a)
        elif kind == "alltoall":
            body = lambda v, p=p, a=aset: posh.alltoall(
                v, "pe", p["algo"], active_set=a)
        else:
            body = lambda v, a=aset: posh.barrier_all("pe", a)
        out[f"out:{cid}"] = run(body, key)

    h = posh.SymHandle("ctr", (4,), np.dtype(np.int32), 0, 16)
    for cid, kind, owner, aset in ATOMICS:
        a = aset_of({"aset": aset})

        def body(v, kind=kind, owner=owner, a=a):
            rank = jax.lax.axis_index("pe")
            part = rank % 3 != 1
            val = (rank + 1).astype(jnp.int32)
            st = {"ctr": v}
            if kind == "ticket":
                t = posh.TicketLock("pe").acquire_order(part, a)
                return jnp.concatenate([v, t.reshape(1).astype(jnp.int32)])
            if kind == "cswap":
                new, old = posh.atomic_cswap(st, h, 2, (rank * 2) % 5, val,
                                             "pe", part, owner, a)
            else:
                fn = posh.atomic_fadd if kind == "fadd" else posh.atomic_swap
                new, old = fn(st, h, 2, val, "pe", part, owner, a)
            return jnp.concatenate([new["ctr"],
                                    old.reshape(1).astype(jnp.int32)])
        out[f"out:atomic:{cid}"] = run(body, "ctr")

    def comm_case(backend, method, kw, key, heap=None):
        c = C.make_communicator("pe", size=N, backend=backend, heap=heap)
        if method == "top_k_merge":
            def per_pe(v, i):
                gv, gi = c.top_k_merge(v[0], i[0], kw["k"])
                return gv[None], gi[None]
            fn = jax.jit(compat.shard_map(per_pe, mesh=mesh,
                                          in_specs=(P("pe"), P("pe")),
                                          out_specs=(P("pe"), P("pe")),
                                          check_vma=False))
            gv, gi = fn(jnp.asarray(xs["topk_v"]), jnp.asarray(xs["topk_i"]))
            res = np.concatenate([np.asarray(gv),
                                  np.asarray(gi).astype(np.float32)], -1)
        else:
            res = run(lambda v: getattr(c, method)(v, **kw), key)
        return res, json.dumps(c.stats(), sort_keys=True)

    for method, kw, key in COMM:
        for backend in ("xla", "posh"):
            res, st = comm_case(backend, method, kw, key)
            cid = f"{backend}:{_comm_id(method, kw, key)}"
            out[f"out:{cid}"], out[f"stats:{cid}"] = res, np.array(st)
    for method, kw, key in JAX_PALLAS:
        res, st = comm_case("pallas", method, kw, key)
        cid = f"pallas:{_comm_id(method, kw, key)}"
        out[f"out:{cid}"], out[f"stats:{cid}"] = res, np.array(st)
    heap = posh.SymmetricHeap(("pe",))
    fp = heap.fingerprint()
    res, _ = comm_case("posh", *HEAP_CASE, heap=heap)
    assert heap.fingerprint() == fp
    out["out:heap"], out["heap_fingerprint"] = res, np.array(fp)
    np.savez(out_path, **out)


# ======================================================================
# the port's side
# ======================================================================
@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_comm") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--jax-worker", str(path)], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _tin(ref, key):
    t = torch.from_numpy(ref[f"in:{key}"].copy())
    return t.to(torch.bfloat16) if key.endswith("_bf16") else t


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _bits_equal(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _xla_close(got, want, x, bf16, what):
    """The xla tolerance stated in the module docstring."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if bf16:
        # one bf16 ulp of the reference value (8 mantissa bits)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert np.all(np.abs(got - want) <= ulp), what
    else:
        atol = 1e-6 * float(np.abs(x).max()) * N
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol,
                                   err_msg=what)


def _aset(p):
    from repro_torch import core
    a = ASETS[p.get("aset", "full")]
    return None if a is None else core.ActiveSet(*a)


def _run_core(kind, p, x):
    from repro_torch import core
    aset = _aset(p)
    if kind == "allreduce":
        return core.allreduce(x, p["op"], "pe", p["algo"], active_set=aset)
    if kind == "broadcast":
        return core.broadcast(x, p["root"], "pe", p["algo"], active_set=aset)
    if kind == "fcollect":
        return core.fcollect(x, "pe", p["algo"], active_set=aset)
    if kind == "reduce":
        return core.reduce(x, p["root"], p["op"], "pe", active_set=aset)
    if kind == "reduce_scatter":
        return core.reduce_scatter(x, p["op"], "pe", p["algo"],
                                   active_set=aset)
    if kind == "alltoall":
        return core.alltoall(x, "pe", p["algo"], active_set=aset)
    return core.barrier_all(core.Team(("pe",), (N,)), aset, device="cpu")


@pytest.mark.parametrize("cid,key,kind,p", CORE, ids=[c[0] for c in CORE])
def test_collective_matches_reference(ref, cid, key, kind, p):
    x = _tin(ref, key)
    x_before = x.clone()
    got = _np(_run_core(kind, p, x))
    assert torch.equal(x, x_before), "the collective wrote to its input"
    want = ref[f"out:{cid}"]
    if p.get("algo") == "xla":
        _xla_close(got, want, ref[f"in:{key}"], key.endswith("_bf16"), cid)
    else:
        _bits_equal(got, want, cid)


def _comm_call(comm, method, kw, ref, key):
    if method == "top_k_merge":
        v = torch.from_numpy(ref["in:topk_v"].copy())
        i = torch.from_numpy(ref["in:topk_i"].copy())
        gv, gi = comm.top_k_merge(v, i, kw["k"])
        return torch.cat([gv, gi.to(torch.float32)], -1)
    return getattr(comm, method)(_tin(ref, key), **kw)


@pytest.mark.parametrize("cid,kind,owner,aset", ATOMICS,
                         ids=[a[0] for a in ATOMICS])
def test_atomics_match_reference(ref, cid, kind, owner, aset):
    """Owner-computes fetch-&-op over the stacked team: the owner's new
    cell and every PE's fetched value equal the reference's, exactly."""
    from repro_torch import core
    from repro_torch.core.heap import SymHandle
    x = torch.from_numpy(ref["in:ctr"].copy())
    rank = torch.arange(N)
    part, val, a = rank % 3 != 1, (rank + 1).to(torch.int32), _aset(
        {"aset": aset})
    h = SymHandle("ctr", (4,), torch.int32, 0, 16)
    st = {"ctr": x}
    if kind == "ticket":
        t = core.TicketLock(core.Team(("pe",), (N,))).acquire_order(part, a)
        got = torch.cat([x, t[:, None].to(torch.int32)], 1)
    else:
        if kind == "cswap":
            new, old = core.atomic_cswap(st, h, 2, (rank * 2) % 5, val, "pe",
                                         part, owner, a)
        else:
            fn = core.atomic_fadd if kind == "fadd" else core.atomic_swap
            new, old = fn(st, h, 2, val, "pe", part, owner, a)
        got = torch.cat([new["ctr"], old.reshape(N, 1).to(torch.int32)], 1)
        assert torch.equal(st["ctr"], x), "the atomic wrote to its input"
    _bits_equal(got.numpy(), ref[f"out:atomic:{cid}"], cid)


COMM_IDS = [f"{b}:{_comm_id(*c)}" for b in BACKENDS for c in COMM]
COMM_PARAMS = [(b,) + c for b in BACKENDS for c in COMM]


@pytest.mark.parametrize("backend,method,kw,key", COMM_PARAMS, ids=COMM_IDS)
def test_communicator_matches_reference(ref, backend, method, kw, key):
    from repro_torch import comm as C
    c = C.make_communicator("pe", size=N, backend=backend)
    got = _np(_comm_call(c, method, kw, ref, key))
    cid = _comm_id(method, kw, key)
    # posh and pallas against the reference's posh, bit for bit; xla
    # against the reference's xla within the stated tolerance
    want_b = "xla" if backend == "xla" else "posh"
    want = ref[f"out:{want_b}:{cid}"]
    if backend == "xla":
        x = ref["in:topk_v"] if method == "top_k_merge" else ref[f"in:{key}"]
        _xla_close(got, want, x, key.endswith("_bf16"), f"{backend}:{cid}")
    else:
        _bits_equal(got, want, f"{backend}:{cid}")
    # instrumentation: equal to the reference backend's own stats (the
    # reference's pallas stats are its posh stats under another name)
    want_stats = json.loads(str(ref[f"stats:{want_b}:{cid}"]))
    assert c.stats() == want_stats, (c.stats(), want_stats)


@pytest.mark.parametrize("method,kw,key", JAX_PALLAS,
                         ids=[_comm_id(*c) for c in JAX_PALLAS])
def test_reference_pallas_equals_its_posh(ref, method, kw, key):
    """The reference's own pallas backend (the Pallas copy in interpret
    mode) is its posh backend bit for bit — the contract the port's
    pallas rows are held to."""
    cid = _comm_id(method, kw, key)
    _bits_equal(ref[f"out:pallas:{cid}"], ref[f"out:posh:{cid}"], cid)
    assert json.loads(str(ref[f"stats:pallas:{cid}"])) == \
        json.loads(str(ref[f"stats:posh:{cid}"]))


@pytest.mark.parametrize("backend", ["posh", "pallas"])
def test_heap_bound_ring_leaves_fingerprint(ref, backend):
    """Lemma 1: the heap-bound ring psum allocates its chunk buffer as
    symmetric scratch and frees it — the fingerprint is unchanged, and
    an empty heap's fingerprint is the reference's."""
    from repro_torch import comm as C
    from repro_torch import core
    heap = core.SymmetricHeap(("pe",))
    fp = heap.fingerprint()
    assert fp == str(ref["heap_fingerprint"])
    c = C.make_communicator("pe", size=N, backend=backend, heap=heap)
    got = _np(c.psum(_tin(ref, HEAP_CASE[2])))
    assert heap.fingerprint() == fp
    assert heap.used_bytes() == 0 and heap.frag_blocks() == 1
    _bits_equal(got, ref["out:heap"], "heap ring")


def test_communicator_surface():
    """What the parity cases do not reach: pytrees (each leaf dispatched
    and recorded by its own size), the 1-PE identity short-circuit,
    rank/axis_name, the queue bound to the team, the stacked-shape
    check, and the tree-level reductions (``tree_psum``, ``tree_pmean``,
    ``bucketed_psum``, ``compressed_psum``) of the DP gradients."""
    from repro_torch import comm as C
    from repro_torch import core
    c = C.make_communicator("pe", size=N, backend="pallas")
    x, y = torch.randn(N, 5), torch.randn(N, 5000)
    out = c.psum({"a": x, "b": [y]})
    torch.testing.assert_close(out["a"], x.sum(0).expand_as(x))
    torch.testing.assert_close(out["b"][0], y.sum(0).expand_as(y))
    assert c.stats()["psum"] == {"calls": 2, "bytes": 20 + 20000,
                                 "algos": {"tree": 1, "ring": 1}}
    assert c.rank("cpu").tolist() == list(range(N)) and c.axis_name == "pe"
    with pytest.raises(ValueError, match="stacked"):
        c.psum(torch.randn(N - 1, 5))
    one = C.make_communicator("pe", size=1, backend="posh")
    z = torch.randn(1, 3, 4)
    assert one.psum(z) is z
    assert one.all_gather(z, axis=1, tiled=False).shape == (1, 3, 1, 4)
    assert one.stats()["psum"]["algos"] == {"identity": 1}
    heap = core.SymmetricHeap(("pe",))
    h = heap.alloc("w", (4,), np.float32)
    q = c.queue(heap.zeros_state(N, device="cpu"))
    q.put_nbi(h, torch.ones(N, 2), [(0, 3)], offset=1)
    assert q.quiet()["w"][3].tolist() == [0.0, 1.0, 1.0, 0.0]
    # the tree-level reductions: the DP gradients' delegates
    tree = {"a": x, "b": [y]}
    assert torch.equal(c.tree_psum(tree)["b"][0], out["b"][0])
    torch.testing.assert_close(c.tree_pmean(tree)["a"], out["a"] / N)
    assert torch.equal(c.bucketed_psum(tree, bucket_bytes=64)["b"][0],
                       out["b"][0])
    red, st = c.compressed_psum(tree, scheme="none", mean=False)
    assert st is None and torch.equal(red["a"], out["a"])
    with pytest.raises(ValueError, match="multi-axis team"):
        core.allreduce(x, "sum", ("dp", "tp"))
    t = core.Team(("dp", "tp"), (2, 4))
    torch.testing.assert_close(core.allreduce(x, "sum", t, "ring"),
                               core.allreduce(x, "sum", "pe", "ring"))


def test_heap_state_and_scratch_match_reference():
    """The heap's additions against the reference's heap: the same
    allocation sequence (``align_alloc``, ``scratch`` nested, frees) gives
    the same fingerprint, used bytes and free blocks; ``zeros_state``
    stacks every PE's object; ``state_from_numpy`` carries a reference
    state across, bf16 included, bit for bit."""
    import jax.numpy as jnp
    from repro.core import heap as jheap
    from repro_torch.core import heap as theap
    hs = (jheap.SymmetricHeap(("pe",)), theap.SymmetricHeap(("pe",)))
    for h in hs:
        h.alloc("a", (37,), np.float32)
        h.align_alloc("b", (3, 5), np.int32, 4096)
        with h.scratch((8, 5), np.float32, tag="ring") as sh:
            assert sh.name.startswith("__ring_")
            with h.scratch((2,), np.int64):
                mid = (h.fingerprint(), h.used_bytes(), h.frag_blocks())
        h.free("a")
    assert hs[0].fingerprint() == hs[1].fingerprint()
    assert (hs[0].used_bytes(), hs[0].frag_blocks()) == \
        (hs[1].used_bytes(), hs[1].frag_blocks())
    st = hs[1].zeros_state(N, device="cpu")
    assert set(st) == {"b"} and st["b"].shape == (N, 3, 5) \
        and st["b"].dtype == torch.int32
    assert mid[1] > hs[1].used_bytes()
    src = {"f": np.asarray(jnp.linspace(-3, 3, N * 6, dtype=jnp.bfloat16)
                           .reshape(N, 6)),
           "i": np.arange(N * 2, dtype=np.int64).reshape(N, 2)}
    got = theap.state_from_numpy(src, device="cpu")
    assert got["f"].dtype == torch.bfloat16 and got["i"].dtype == torch.int64
    np.testing.assert_array_equal(got["f"].view(torch.int16).numpy(),
                                  src["f"].view(np.int16))
    np.testing.assert_array_equal(got["i"].numpy(), src["i"])


# ======================================================================
# the benchmark entry point (CPU, tiny sizes)
# ======================================================================
@pytest.mark.parametrize("elems", [64, 4104, 8200])
def test_staged_payload_model_matches_the_schedules(elems):
    """comm_bench's model of each schedule's rounds (which the chip run
    holds the copy kernel's launch count to) is what the schedules
    actually stage, round by round."""
    from repro_torch import comm as C
    from repro_torch.core import p2p
    from repro_torch.launch import comm_bench as cb
    x = torch.randn(N, elems)
    for op, (algos, body) in cb.SCHEDULES.items():
        for algo in algos:
            seen = []

            def spy(p):
                seen.append(p[0].numel() * p.element_size())
                return p.clone()

            with p2p.staged_payloads(spy):
                body(x, algo)
            assert seen == cb.staged_payload_bytes(op, algo, N, elems, 4), \
                (op, algo)
    # and through the communicator, whose dispatch picks the algorithm
    for op in cb.COMM_OPS:
        c = C.make_communicator("pe", size=N, backend="posh")
        seen = []
        with p2p.staged_payloads(lambda p: seen.append(
                p[0].numel() * p.element_size()) or p.clone()):
            cb.comm_call(c, op, x)
        (algo,) = c.stats()[op]["algos"]
        assert seen == cb.staged_payload_bytes(op, algo, N, elems, 4), op


def test_comm_bench_runs_on_the_cpu_when_asked():
    from repro_torch.launch import comm_bench as cb
    bench = cb.run("cpu", sizes=[256, 4096], copy_sizes=[4096], reps=1,
                   quiet=True)
    keys = {"op", "algo", "nbytes", "elems", "us_per_call", "bytes_per_s"}
    assert all(set(r) == keys for r in bench["results"])
    algos = {(r["op"], r["algo"]) for r in bench["results"]}
    assert ("psum", "backend:pallas") in algos
    assert ("symm_copy", "vmem_512x512") in algos
    assert not any(op == "combine" for op, _ in algos)   # off every path
    assert len(bench["checks"]) == 2 * len(cb.COMM_OPS)
    assert all(c["pallas_eq_posh"] and c["posh_vs_xla"]
               for c in bench["checks"])
    assert bench["meta"]["device"] == "cpu" and bench["meta"]["n_pe"] == N
    assert set(bench["tuned_thresholds"]) == {"allreduce_small_bytes",
                                              "allgather_small_bytes"}


def test_comm_bench_raises_without_a_gpu_unless_cpu_is_asked():
    from repro_torch.launch import comm_bench as cb
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default run would use it")
    with pytest.raises(RuntimeError, match="CUDA"):
        cb.main(["--sizes", "256", "--copy-sizes", "4096", "--reps", "1"])


def _new_tensor(what, device):
    """One call of each public function that makes a tensor of its own
    rather than taking one."""
    from repro_torch import comm as C
    from repro_torch import core
    team = core.Team(("pe",), (N,))
    if what == "barrier_all":
        return core.barrier_all(team, device=device)
    if what == "SignalPad.zeros":
        return core.SignalPad(core.SymmetricHeap(("pe",)), 4).zeros(N, device)
    if what == "Team.my_pe":
        return team.my_pe(device)
    if what == "my_pe":
        return core.my_pe("pe", N, device=device)
    if what == "Communicator.rank":
        return C.make_communicator("pe", size=N, backend="posh").rank(device)
    return core.TicketLock(team).acquire_order(device=device)


@pytest.mark.parametrize("what", ["barrier_all", "SignalPad.zeros",
                                  "Team.my_pe", "my_pe", "Communicator.rank",
                                  "TicketLock"])
def test_new_tensors_go_to_the_card_unless_cpu_is_asked(monkeypatch, what):
    """No device means the card: without a GPU the call raises, and it
    runs on the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _new_tensor(what, None)
    got = _new_tensor(what, "cpu")
    assert got.device.type == "cpu" and got.shape[0] == N, what


if __name__ == "__main__" and sys.argv[1:2] == ["--jax-worker"]:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _jax_worker(sys.argv[2])
