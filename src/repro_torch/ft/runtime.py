"""Fault-tolerance runtime — the counterpart of ``repro.ft.runtime``
(the paper-§4.7 'monitor them, and take the appropriate actions if one
of them dies', scaled to pods).  Plain Python, as the reference's: it
imports neither torch nor anything of the kernels.

Pieces, each independently testable on CPU:

  FailureDetector   heartbeat bookkeeping; on a real pod this wraps the
                    coordination-service barrier timeout, here it is
                    driven by injected events (tests kill 'nodes')
  run_with_restarts the step loop: on failure -> restore latest
                    checkpoint -> rebuild mesh (possibly smaller) ->
                    continue; data position is a pure function of the
                    step counter so no batches are lost or repeated
  plan_elastic_remesh
                    given surviving pod count, produce the new mesh
                    shape + the ParallelCtx changes (dp shrinks, tp is
                    preserved — TP ranks share model shards, so losing a
                    TP peer means losing the whole replica)
  StragglerPolicy   deadline-based step skip accounting: replicas that
                    miss the deadline contribute a zero-weighted
                    gradient for that step (gradient re-weighting keeps
                    the estimator unbiased); repeated misses demote the
                    node to the failure path
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class FailureDetector:
    n_nodes: int
    timeout_s: float = 60.0
    _last_beat: dict = dataclasses.field(default_factory=dict)
    _dead: set = dataclasses.field(default_factory=set)

    def heartbeat(self, node: int, t: Optional[float] = None) -> None:
        self._last_beat[node] = time.monotonic() if t is None else t

    def inject_failure(self, node: int) -> None:
        self._dead.add(node)

    def check(self, now: Optional[float] = None) -> list[int]:
        now = time.monotonic() if now is None else now
        dead = set(self._dead)
        for node, beat in self._last_beat.items():
            if now - beat > self.timeout_s:
                dead.add(node)
        return sorted(dead)

    def alive(self, now: Optional[float] = None) -> list[int]:
        dead = set(self.check(now))
        return [n for n in range(self.n_nodes) if n not in dead]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple
    axis_names: tuple
    dp_size: int
    tp_size: int
    dropped_replicas: int


def plan_elastic_remesh(alive_pods: int, pods: int, data: int, model: int,
                        multi_pod: bool = True) -> ElasticPlan:
    """Shrink the pod axis to the surviving pods.  TP (model axis) is
    never split across pods in our layout, so pod loss removes whole DP
    replicas; batch is re-sharded over the survivors."""
    if alive_pods < 1:
        raise RuntimeError("no pods survive — unrecoverable")
    if multi_pod:
        return ElasticPlan((alive_pods, data, model),
                           ("pod", "data", "model"),
                           dp_size=alive_pods * data, tp_size=model,
                           dropped_replicas=(pods - alive_pods) * data)
    return ElasticPlan((data, model), ("data", "model"),
                       dp_size=data, tp_size=model, dropped_replicas=0)


@dataclasses.dataclass
class StragglerPolicy:
    deadline_s: float = 120.0
    demote_after: int = 3
    _miss_count: dict = dataclasses.field(default_factory=dict)

    def record(self, node: int, step_time_s: float) -> str:
        """Returns 'ok' | 'skip' | 'demote'."""
        if step_time_s <= self.deadline_s:
            self._miss_count[node] = 0
            return "ok"
        self._miss_count[node] = self._miss_count.get(node, 0) + 1
        if self._miss_count[node] >= self.demote_after:
            return "demote"
        return "skip"

    def grad_weight(self, decisions: list[str]) -> float:
        """Re-weighting factor so the mean over contributing replicas
        stays unbiased when some are skipped."""
        n = len(decisions)
        ok = sum(1 for d in decisions if d == "ok")
        if ok == 0:
            return 0.0
        return n / ok


def run_with_restarts(make_step: Callable, init_state: Callable,
                      checkpointer, n_steps: int,
                      failure_schedule: Optional[dict] = None,
                      ckpt_every: int = 10):
    """Generic restart loop, for tests and training launchers.

    make_step(attempt) -> (step_fn, state_spec_info); init_state(attempt)
    -> state.  ``failure_schedule`` maps step -> exception to inject
    (tests).  On failure: restore from the newest checkpoint and
    continue — the loop never loses more than ckpt_every steps.
    """
    failure_schedule = failure_schedule or {}
    attempt = 0
    step_fn = make_step(attempt)
    state = init_state(attempt)
    step = 0
    restarts = 0
    losses = []
    while step < n_steps:
        try:
            if step in failure_schedule and failure_schedule[step]:
                exc = failure_schedule.pop(step)
                raise exc
            state, metrics = step_fn(state, step)
            losses.append(float(metrics["loss"]))
            step += 1
            if step % ckpt_every == 0:
                checkpointer.save_async(step, state)
        except (RuntimeError, IOError) as e:
            restarts += 1
            attempt += 1
            checkpointer.wait()
            state, restored_step = checkpointer.restore(state)
            step = restored_step
            step_fn = make_step(attempt)
    checkpointer.wait()
    return state, {"losses": losses, "restarts": restarts,
                   "final_step": step}
