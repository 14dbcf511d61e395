"""VEF-like trace representation: per-node programs as phase-structured steps.

A Trace is a sequence of Steps over a set of participating nodes (an
*allocation* of global node ids on the full topology — applications in the
paper run on a subset of the 4160-node system while idle nodes draw minimum
power).

Step semantics (superstep / BSP approximation of MPI dependency replay —
see DESIGN.md §3):
  1. each node in ``compute_nodes`` advances its clock by ``compute_secs``;
  2. every message in ``msgs`` [(src, dst, bytes)] is injected at its source's
     clock; deliveries advance destination clocks;
  3. if ``barrier``, all participants synchronize to the max clock.
Collectives are expanded into multiple steps (one per round), so their
internal dependency structure is preserved.

The ``version`` counter below counts builder-API mutations (a plan cache
keyed on the trace can use it to detect appended steps).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Step:
    compute_nodes: Optional[np.ndarray] = None   # (K,) global node ids
    compute_secs: Optional[np.ndarray] = None    # (K,) f64 seconds
    msgs: Optional[np.ndarray] = None            # (M,3) int64 [src,dst,bytes]
    barrier: bool = False


@dataclass
class Trace:
    nodes: np.ndarray                            # participating node ids
    steps: List[Step] = field(default_factory=list)
    name: str = ""
    version: int = field(default=0, repr=False, compare=False)

    # -- builder helpers -----------------------------------------------------
    def compute(self, secs):
        """Uniform (or per-node array) compute phase on all participants."""
        secs = np.broadcast_to(np.asarray(secs, np.float64),
                               self.nodes.shape).copy()
        self.steps.append(Step(compute_nodes=self.nodes.copy(),
                               compute_secs=secs))
        self.version += 1
        return self

    def messages(self, msgs, barrier=False):
        msgs = np.asarray(msgs, np.int64).reshape(-1, 3)
        self.steps.append(Step(msgs=msgs, barrier=barrier))
        self.version += 1
        return self

    def rounds(self, rounds, barrier_last=False):
        """Append a list of message rounds (each a (M,3) array)."""
        for i, r in enumerate(rounds):
            self.messages(r, barrier=barrier_last and i == len(rounds) - 1)
        return self

    def barrier(self):
        self.steps.append(Step(barrier=True))
        self.version += 1
        return self

    @property
    def n_messages(self):
        return sum(len(s.msgs) for s in self.steps if s.msgs is not None)

    @property
    def total_bytes(self):
        return sum(int(s.msgs[:, 2].sum()) for s in self.steps
                   if s.msgs is not None)
