"""The FCG loop of the voxel, curvilinear and canonicalized routes, kept on
the card: one FCG iteration captured as a CUDA graph and replayed.

Counterpart of ``fea_tpu/solve/staged.py`` (``_st_k_steps_core``,
``_solve_fpcg_t_staged_once``) and of its batched twin
``_st_k_steps_many``. It computes what the reference computes, in the
H100's form:

  * **The step.** The loop is rotated to put the preconditioner first: the
    V-cycle on r, the Polak-Ribiere beta, ``p = z + beta p``, the masked
    f64 apply and ``<p, Ap>``, the x and r updates, ``||r||^2``. The start
    folds into step one: with ``p = 0`` and a throwaway ``rz = 1``,
    ``beta * 0`` vanishes and ``p = z``.
  * **Freezing.** A step is live while ``done`` (the residual met tol,
    latched on the card against the card's own ``||b||^2``) and ``blown``
    (a residual 1e12 above its start, or NaN) are unset and its index is
    below ``limit``, the iteration budget of the pass. A frozen step leaves
    the state as it was, so the iterate returned is the first one whose
    residual met tol, and ``max_iters`` is honoured exactly however late the
    host looks.
  * **Static buffers.** A step reads and writes one set of tensors made
    once (:class:`_Case`); alpha, beta, rz and rr are 0-d f64 tensors on
    the device. Nothing inside a step moves a value to the host.
  * **On a CUDA tensor** the step of each case is captured once as a CUDA
    graph, after one eager warm-up step on the capture stream (frozen by a
    zero budget) that builds the kernels and sets their shared-memory
    attributes. One capture stream a device serves every capture, so the
    stream's own first-use costs are paid once. The host replays the graph
    once an iteration. After each round of replays it copies every case's
    status row (rr, iterations, done, blown, ``||b||^2``) into one of two
    pinned buffers and records an event; it then waits for the event of
    the round before, so the card always has a round queued while the host
    reads, and it stops replaying a case once it has seen it halt: at most
    one replay a pass runs past convergence, and it is frozen.
  * **On a CPU tensor** the same step runs eagerly and the host reads each
    round at once. That is the plain version, which the tests drive. It
    also runs on the card under the NaN sanitizer
    (``fea_tpu_torch.sanitize``), which sees no operation of a replay.

A replay is one step, so the reference's ``FEA_TPU_STAGED_K`` (steps a
dispatch) has no counterpart here. The captured state of a hierarchy (its
:class:`_Plan`) is kept in this module, keyed on the hierarchy and dropped
with it, so that a later solve or correction pass on the same
``(op, mg)`` captures nothing.

A failed capture or replay raises; nothing falls back to the eager loop on
the card. The kernels' wrappers bump their launch counters (the extruded
apply's ``cuda_extruded.LAUNCHES`` among them), and the extruded route's
Thomas sweeps theirs (``extruded_mg.LAUNCHES``), so a
capture counts what one replay launches: the capture's counts are taken
back and credited again on every replay. The eager warm-up step before a
capture counts once, as any eager step does.
"""
from __future__ import annotations

import functools
import math
import weakref
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from .. import sanitize
from ..dtypes import precise_dot
from ..ops import cuda_apply, cuda_extruded, cuda_stencil, cuda_varstencil, extruded_mg
from ..solvers.cg import SolveStats
from ..utils.profiling import span
from ._types import Solution
from .certify import refine_true

__all__ = ["COUNTS", "solve_operator_fpcg_staged"]

# What the staged loops did, kept like the kernels' LAUNCHES (zero them
# before a solve, read them after): steps run (graph replays on the card,
# eager steps on the CPU), live steps (iterations), the most steps run past
# a case's halt in one pass, status readbacks, graphs captured and the host
# ms of warm-up and capture (the ``fea.fcg.capture`` spans' time).
COUNTS = {"steps": 0, "live": 0, "past": 0, "readbacks": 0, "captures": 0, "capture_ms": 0.0}

_COUNTERS = (cuda_stencil.LAUNCHES, cuda_varstencil.LAUNCHES, cuda_apply.LAUNCHES, extruded_mg.LAUNCHES,
             cuda_extruded.LAUNCHES)
_STATUS = 5  # a case's status row: rr, iterations, done, blown, ||b||^2
_PLANS: dict = {}  # id(hierarchy) -> its _Plan, dropped with the hierarchy
_STREAMS: dict = {}  # device -> the stream every capture on it runs on


class _Case:
    """One right-hand side's FCG state in static tensors, and its captured
    step. ``status`` is this case's row of the plan's status tensor: rr, the
    iteration count, done, blown (flags as 0.0 / 1.0) and ``||b||^2`` live
    there, so the host reads the state itself.

    The step is written in the few kernel families the Python loop and the
    V-cycle already use (arithmetic, compares, ``where``, ``addcmul``): a
    process loads each family's module at its first launch and pays for it
    in its first solve (up to ~30 ms a module on an H100, by
    ``chip_pair.py --solves DIR:profile``)."""

    def __init__(self, index: int, shape, device: torch.device, status: torch.Tensor):
        f64 = torch.float64
        self.index = index

        def vec():
            return torch.zeros(shape, dtype=f64, device=device)

        def scalar(v):
            return torch.full((), v, dtype=f64, device=device)

        self.x, self.r, self.r_old, self.p = vec(), vec(), vec(), vec()
        self.rz, self.thresh2, self.blowup, self.limit = (scalar(v) for v in (1.0, 0.0, 0.0, 0.0))
        self.rr, self.it, self.done, self.blown, self.b2 = status.unbind(0)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.credits: list[tuple[dict, str, int]] = []  # (counter, key, launches a replay)
        self.steps = 0

    def start(self, free: torch.Tensor, b: torch.Tensor, x0: Optional[torch.Tensor], tol: float, limit: int) -> None:
        """Set the state for a pass on ``b`` from ``x0`` (None: zero) whose
        fixed rows hold the prescribed values: r = F b needs no apply,
        because A x0 = x0 on the fixed rows and 0 on the free ones."""
        torch.mul(free, b, out=self.r)
        if x0 is None:
            self.x.zero_()
        else:
            self.x.copy_(x0)
        self.r_old.zero_()
        self.p.zero_()
        self.rz.fill_(1.0)
        self.rr.copy_(precise_dot(self.r, self.r))
        self.b2.copy_(precise_dot(b, b))
        safe = torch.where(self.b2 > 0, self.b2, 1.0)
        torch.mul(safe, tol * tol, out=self.thresh2)
        # a residual 1e12x above its start (or NaN) can only get worse
        torch.mul(torch.where(self.rr > safe, self.rr, safe), 1e12, out=self.blowup)
        self.done.copy_(self.rr <= self.thresh2)
        self.blown.copy_(self.rr != self.rr)
        self.it.zero_()
        self.limit.fill_(limit)
        self.steps = 0

    def step(self, apply: Callable, precond: Callable) -> None:
        """One FCG iteration on the static state, frozen unless live."""
        f64 = torch.float64
        live_f = (1.0 - self.done) * (1.0 - self.blown) * (self.it < self.limit)  # 1.0 or 0.0
        live = live_f > 0
        z = precond(self.r.to(torch.float32)).to(f64)
        rz_new = precise_dot(self.r, z)
        beta = (rz_new - precise_dot(self.r_old, z)) / torch.where(self.rz != 0, self.rz, 1.0)
        torch.where(live, self.r, self.r_old, out=self.r_old)
        # p = z + beta p when live; frozen, p * 1 + 0 * z leaves p as it was
        self.p.mul_(torch.where(live, beta, 1.0)).addcmul_(live_f, z)
        Ap = apply(self.p)
        pAp = precise_dot(self.p, Ap)
        alpha = torch.where(live, rz_new / torch.where(pAp > 0, pAp, 1.0), 0.0)
        self.x.addcmul_(alpha, self.p)
        self.r.addcmul_(alpha, Ap, value=-1.0)
        rr_new = precise_dot(self.r, self.r)
        torch.where(live, rr_new, self.rr, out=self.rr)
        torch.where(live, rz_new, self.rz, out=self.rz)
        self.done.add_(live_f * (rr_new <= self.thresh2))
        self.blown.add_(live_f).sub_(live_f * (rr_new < self.blowup))  # NaN compares false: blown
        self.it.add_(live_f)

    def capture(self, step: Callable[[], None], stream: torch.cuda.Stream, pool) -> None:
        """Capture ``step`` into this case's graph on ``stream``; the launch
        counts the wrappers took during the capture become this graph's
        credits a replay."""
        before = [dict(c) for c in _COUNTERS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                step()
            finally:
                graph.capture_end()
        self.credits = [(c, key, c[key] - was[key]) for c, was in zip(_COUNTERS, before) for key in c
                        if c[key] != was[key]]
        for c, was in zip(_COUNTERS, before):
            c.update(was)  # a capture launches nothing
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        for counter, key, n in self.credits:
            counter[key] += n


class _Plan:
    """The cases of one (operator, hierarchy) pair: their static state, their
    captured steps on the card, one status tensor and two pinned buffers
    the host reads it through.

    Holds the operator (its tensors feed the graphs) but not the hierarchy,
    which keys it in ``_PLANS``: nothing here keeps a hierarchy alive, and
    the plan goes with it."""

    def __init__(self, op, mg, n_cases: int, graphs: bool = True):
        self.op = op
        device = op.free.device
        self.cuda = device.type == "cuda" and graphs
        self.status = torch.zeros((n_cases, _STATUS), dtype=torch.float64, device=device)
        self.cases = [_Case(i, op.free.shape, device, self.status[i]) for i in range(n_cases)]
        self.slot = 0
        if self.cuda:
            # the host reads one round behind the card: two buffers suffice
            self.ring = torch.zeros((2, n_cases, _STATUS), dtype=torch.float64, pin_memory=True)
            self.events = [torch.cuda.Event(), torch.cuda.Event()]
            self._capture(mg, device)

    def _capture(self, mg, device: torch.device) -> None:
        with span("fea.fcg.capture") as capture:
            stream = _STREAMS.get(device)
            if stream is None:
                stream = _STREAMS[device] = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                # warm-up: a fresh case has a zero budget, so the step is frozen
                self.cases[0].step(self.op.apply, mg)
            pool = torch.cuda.graph_pool_handle()  # steps of one plan never run at once
            for case in self.cases:
                case.capture(functools.partial(case.step, self.op.apply, mg), stream, pool)
            torch.cuda.current_stream(device).wait_stream(stream)
        COUNTS["captures"] += len(self.cases)
        COUNTS["capture_ms"] += capture.seconds * 1e3

    def _run_step(self, case: _Case, mg) -> None:
        if self.cuda:
            case.replay()
        else:
            case.step(self.op.apply, mg)
        case.steps += 1
        COUNTS["steps"] += 1

    def _readback(self):
        """Queue a copy of every case's status; returns what :meth:`_read`
        takes."""
        COUNTS["readbacks"] += 1
        if not self.cuda:
            return self.status.cpu().numpy().copy()
        slot = self.slot
        self.slot = 1 - slot
        self.ring[slot].copy_(self.status, non_blocking=True)
        self.events[slot].record(torch.cuda.current_stream(self.status.device))  # the copy's stream
        return slot

    def _read(self, token) -> np.ndarray:
        if not self.cuda:
            return token
        with span("fea.fcg.wait"):
            self.events[token].synchronize()
        return self.ring[token].numpy().copy()

    @span("fea.fcg.run")
    def run(self, cases: list[_Case], mg, limit: int, say: Optional[Callable[[str], None]] = None) -> np.ndarray:
        """Run steps of ``cases`` (started by :meth:`_Case.start`) until
        each has halted or used ``limit``; the final status of every case.
        ``say``, where given, takes a line at each readback."""
        lag = 1 if self.cuda else 0  # rounds the host reads behind the card
        last = self._readback()
        pending = deque([last])
        live = list(cases)
        reads = 0
        while True:
            while len(pending) > lag:
                status = self._read(pending.popleft())
                live = [c for c in live if not (status[c.index, 2] or status[c.index, 3])]
                reads += 1
                if say is not None and live:
                    worst = max(status[c.index, 0] / max(status[c.index, 4], 1e-300) for c in live)
                    say(f"round {reads}: {len(live)} case(s) live, worst rel_res {math.sqrt(worst):.3e}")
            live = [c for c in live if c.steps < limit]
            if not live:
                break
            for case in live:
                self._run_step(case, mg)
            last = self._readback()
            pending.append(last)
        status = self._read(last)  # the stream orders it after every step run
        for case in cases:
            n = int(status[case.index, 1])
            COUNTS["live"] += n
            COUNTS["past"] = max(COUNTS["past"], case.steps - n)
        return status


def _plan_for(op, mg, n_cases: int) -> _Plan:
    """The plan of (op, mg) for ``n_cases`` cases: one a hierarchy, kept
    until the hierarchy goes, so that a solve captures at most once and
    later solves and correction passes on the same pair capture nothing."""
    if sanitize.active():  # the eager step, kept by no one
        return _Plan(op, mg, n_cases, graphs=False)
    key = id(mg)
    plan = _PLANS.get(key)
    if plan is not None and plan.op is op and len(plan.cases) == n_cases:
        return plan
    if plan is None:
        try:
            weakref.finalize(mg, _PLANS.pop, key, None)
        except TypeError:  # a preconditioner that takes no weak reference keeps no plan
            return _Plan(op, mg, n_cases)
    else:
        del _PLANS[key], plan  # free the old plan's memory before the new one takes its own
    plan = _PLANS[key] = _Plan(op, mg, n_cases)
    return plan


def _stats(row: np.ndarray) -> SolveStats:
    """A pass's recurrence stats from a case's status row."""
    rn = math.sqrt(row[0])
    b_norm = math.sqrt(max(row[4], 0.0))
    return SolveStats(iterations=int(row[1]), residual_norm=rn, relative_residual=rn / (b_norm if b_norm > 0 else 1.0),
                      converged=bool(row[2]))


def _solve_cases(op, mg, loads: torch.Tensor, prescribed: torch.Tensor, *, tol: float, max_iters: int,
                 refine: bool, max_refine: int, say: Optional[Callable[[str], None]] = None) -> list[Solution]:
    """FCG for every case of ``loads`` and ``prescribed`` (k, N, 3), the
    cases advancing together; then, case by case, the true-residual
    certification of ``certify.refine_true``, its correction passes
    replaying the case's graph."""
    plan = _plan_for(op, mg, loads.shape[0])
    free = op.free
    for i, case in enumerate(plan.cases):
        case.start(free, op.rhs(loads[i], prescribed[i]), (1.0 - free) * prescribed[i], tol, max_iters)
    status = plan.run(plan.cases, mg, max_iters, say)
    sols = []
    for i, case in enumerate(plan.cases):
        if not refine:
            u = case.x.clone()
            sols.append(Solution(displacements=u, reactions=op.apply_raw(u), stats=_stats(status[i])))
            continue

        def correct(r, tol_pass, case=case):
            if say is not None:
                say(f"correction pass of case {case.index}")
            case.start(free, r, None, tol_pass, max_iters)
            row = plan.run([case], mg, max_iters, say)[case.index]
            return case.x.clone(), _stats(row)  # the correction once its pass has run

        # refine_true corrects the clone in place
        sols.append(refine_true(op, loads[i], math.sqrt(max(status[i, 4], 0.0)), case.x.clone(), _stats(status[i]),
                                correct, tol=tol, max_refine=max_refine))
    return sols


def solve_operator_fpcg_staged(
    op_hi,
    loads: torch.Tensor,
    prescribed: Optional[torch.Tensor],
    mg,
    *,
    tol: float = 1e-8,
    max_iters: int = 300,
    refine_true: bool = True,
    max_refine: int = 3,
    progress: Optional[Callable[[str], None]] = None,
) -> Solution:
    """Solve the masked system of ``op_hi`` (f64) to a TRUE relative
    residual of ``tol``: the FCG loop of :func:`solve_operator_fpcg`, held on
    the card (see the module's note). Counterpart of
    ``fea_tpu.solve.solve_operator_fpcg_t_staged``.

    ``mg`` maps f32 (N, 3) -> (N, 3) (the V-cycle); the graphs of its steps
    are kept on it. ``refine_true`` (default): certify the result against
    the true f64 residual and run up to ``max_refine`` correction passes on
    the same graph; False reports the recurrence. ``progress``: a callable
    given a line of text at the host's readbacks and passes.
    """
    if not isinstance(op_hi.free, torch.Tensor):
        raise TypeError("solve_operator_fpcg_staged: the operator's vectors must be tensors on one device; "
                        "the sharded solve runs solve_operator_fpcg")
    hi = torch.float64
    loads = loads.to(hi)
    prescribed = torch.zeros_like(loads) if prescribed is None else prescribed.to(hi)
    (sol,) = _solve_cases(
        op_hi, mg, loads[None], prescribed[None], tol=tol, max_iters=max_iters, refine=refine_true,
        max_refine=max_refine, say=progress,
    )
    return sol
