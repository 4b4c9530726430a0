"""The comparison that decides ``correct`` comes out false when the
timed path is broken underneath a whole run (the harness's look for a
card skipped, everything else as on the card): once for each fault these
cells can have, and for the control, the reference in float32 in the
program's place. One chip a cell: no exchange between chips to leave
out."""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import fea_tpu_torch as ftt
from benchmark.reference import control
from benchmark.tests import tiny

torch.set_num_threads(1)


def _unchanged(sol):
    """The solve returns the state it starts from."""
    return SimpleNamespace(displacements=torch.zeros_like(sol.displacements),
                           reactions=torch.zeros_like(sol.reactions), stats=sol.stats)


def _altered_u(sol):
    """One displacement altered where it is produced."""
    u = sol.displacements.clone()
    flat = u.view(-1)
    i = int(flat.abs().argmax())
    flat[i] *= 1.001
    return dataclasses.replace(sol, displacements=u)


def _altered_reaction(sol):
    """One reaction altered where it is produced."""
    r = sol.reactions.clone()
    flat = r.view(-1)
    flat[int(flat.abs().argmax())] *= 1.001
    return dataclasses.replace(sol, reactions=r)


class Broken:
    """fea_tpu_torch with each answer broken by ``fault``."""

    def __init__(self, fault):
        self.fault = fault

    def __getattr__(self, name):
        return getattr(ftt, name)

    def solve(self, scene, **kw):
        return self.fault(ftt.solve(scene, **kw))

    def solve_many(self, scene, loads, **kw):
        return self.fault(ftt.solve_many(scene, loads, **kw))


class HalfBatch(Broken):
    """Half of each batch left out, the mean of the rest in its place."""

    def __init__(self):
        super().__init__(None)

    def solve_many(self, scene, loads, **kw):
        k, h = loads.shape[0], loads.shape[0] // 2
        sol = ftt.solve_many(scene, loads[:h], **kw)
        fill = lambda t: torch.cat([t, t.mean(0, keepdim=True).expand(k - h, *t.shape[1:])])  # noqa: E731
        more = lambda a: np.concatenate([a, np.repeat(a[:1], k - h)])  # noqa: E731
        st = sol.stats
        return SimpleNamespace(displacements=fill(sol.displacements), reactions=fill(sol.reactions),
                               stats=SimpleNamespace(iterations=more(st.iterations), converged=more(st.converged),
                                                     relative_residual=more(st.relative_residual)))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny_voxel.batch8", "tiny_curv.loadcases", "tiny_voxel.loadcases"])
def test_sound_program_is_correct(root, cell):
    rc, lines, err = tiny.run(root, cell)
    assert rc == 0 and tiny.result(lines)["correct"], err


@pytest.mark.parametrize("api", [Broken(_unchanged), Broken(_altered_u), Broken(_altered_reaction)],
                         ids=["unchanged", "altered_u", "altered_reaction"])
@pytest.mark.parametrize("cell", ["tiny_voxel.batch8", "tiny_curv.loadcases"])
def test_fault_is_not_correct(root, cell, api):
    rc, lines, err = tiny.run(root, cell, api=api)
    assert rc == 0 and tiny.result(lines)["correct"] is False, err


def test_half_batch_is_not_correct(root):
    rc, lines, err = tiny.run(root, "tiny_voxel.batch8", api=HalfBatch())
    assert rc == 0 and tiny.result(lines)["correct"] is False, err


@pytest.mark.parametrize("cell", ["tiny_voxel.batch8", "tiny_curv.loadcases"])
def test_control_is_not_correct(root, cell):
    """The reference in float32 certifies nothing: its reactions fail."""
    rc, lines, err = tiny.run(root, cell, api=control)
    res = tiny.result(lines)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["reactions"]["value"] > res["checks"]["reactions"]["limit"]


@pytest.mark.parametrize("cell", ["tiny_voxel.batch8", "tiny_voxel.loadcases", "tiny_curv.loadcases"])
def test_rounded_control_fails_the_residual(root, cell):
    """The program's answers rounded to float32, claimed certified: the
    residual is read, and fails."""
    rc, lines, err = tiny.run(root, cell, api=control.Rounded(ftt))
    res = tiny.result(lines)
    assert rc == 0 and res["correct"] is False and res["failed"] == 0
    assert res["checks"]["residual"]["value"] > res["checks"]["residual"]["limit"]
