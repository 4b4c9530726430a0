"""The one traffic generator: a closed loop of solve requests, made from
a traffic mix's parameters, the configuration and the run's seed.

Request r (warm-up requests first, numbered from 0) is a pure function
of (seed, r): its mesh and its loads are drawn again from the same
numbers when the reference judges it after the window.

Parameters of a mix (``traffic/<mix>.json``):

* ``entry``: ``solve`` (one load case a request) or ``solve_many``;
* ``cases``: load cases a request;
* ``mesh``: ``shared`` (one mesh made in set-up, the same tensors in
  every request) or ``fresh`` (a new mesh every request, drawn from
  (seed, request) by the configuration's generator);
* ``load``: ``config`` (the configuration's own total and direction)
  or ``components`` (each case's total on axis a drawn uniform on
  ``load_components[a]`` times ``load_scale``, from (seed, request));
  either way spread evenly over the tip nodes;
* ``warmup_requests``: requests of set-up, before the window;
* ``trace_requests``: requests the traced slice of a ``--trace 1`` run
  profiles;
* ``check_requests``: requests of the window the reference judges, drawn
  from the seed over all the window's requests.
"""
from __future__ import annotations

import numpy as np
import torch

MESH, LOAD, SAMPLE = 0, 1, 2  # streams of random numbers


def rng(seed: int, *keys: int) -> np.random.Generator:
    """The generator of stream ``keys`` of ``seed`` (any integer)."""
    return np.random.default_rng([seed % 2**64, *keys])


class Generator:
    def __init__(self, config: dict, mix: dict, mesh_module, seed: int):
        self.config, self.mix, self.seed = config, mix, seed
        self.mesh_module = mesh_module
        self.cases = int(mix["cases"])
        self.shared = mix["mesh"] == "shared"
        if mix["mesh"] not in ("shared", "fresh") or mix["load"] not in ("config", "components"):
            raise ValueError(f"traffic: unknown mesh {mix['mesh']!r} or load {mix['load']!r}")
        if mix["entry"] not in ("solve", "solve_many") or (mix["entry"] == "solve" and self.cases != 1):
            raise ValueError(f"traffic: entry {mix['entry']!r} with {self.cases} cases a request")
        self.base = self._build(0)

    def _build(self, stream: int) -> dict:
        mesh = self.mesh_module.build(self.config, rng(self.seed, MESH, stream))
        if mesh["nodes"].size != self.config["dof"]:
            raise ValueError(f"traffic: the mesh has {mesh['nodes'].size} DOF, its configuration {self.config['dof']}")
        return mesh

    def mesh(self, r: int) -> dict:
        """Request r's mesh."""
        return self.base if self.shared else self._build(r + 1)

    def tip_loads(self, r: int, mesh: dict) -> np.ndarray:
        """(cases, 3): the load on each tip node in each case of request r."""
        if self.mix["load"] == "config":
            total = np.tile(self.config["load_total"] * np.asarray(self.config["load_direction"], np.float64),
                            (self.cases, 1))
        else:
            lo, hi = np.asarray(self.mix["load_components"], np.float64).T
            total = self.mix["load_scale"] * rng(self.seed, LOAD, r).uniform(lo, hi, (self.cases, 3))
        return total / mesh["tip"].sum()

    def loads(self, r: int, mesh: dict) -> np.ndarray:
        """(cases, N, 3): request r's loads, as the reference takes them."""
        out = np.zeros((self.cases,) + mesh["nodes"].shape)
        out[:, mesh["tip"]] = self.tip_loads(r, mesh)[:, None, :]
        return out


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from the
    seed: item i replaces a kept one with probability k / (i + 1)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.kept = k, rng(seed, SAMPLE), 0, {}

    def wants(self) -> int | None:
        """The slot the next item goes into, or None; counts the item."""
        i, self.seen = self.seen, self.seen + 1
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None


class HostSlots:
    """Host buffers for the sampled answers, one pair a slot, pinned on
    a card and made before the window: keeping an answer inside the
    window is then one copy, with no allocation and no page faults."""

    def __init__(self, k: int, pin: bool):
        self.k, self.pin, self.bufs = k, pin, {}

    def _pair(self, slot: int, u: torch.Tensor, reac: torch.Tensor) -> tuple:
        if slot not in self.bufs:
            self.bufs[slot] = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=self.pin) for t in (u, reac))
        return self.bufs[slot]

    def reserve(self, u: torch.Tensor, reac: torch.Tensor) -> None:
        """Every slot's pair, shaped as ``u`` and ``reac``."""
        for slot in range(self.k):
            self._pair(slot, u, reac)

    def store(self, slot: int, u: torch.Tensor, reac: torch.Tensor) -> tuple:
        bu, br = self._pair(slot, u, reac)
        bu.copy_(u)
        br.copy_(reac)
        return bu, br
