"""Synthetic application trace generators (paper §4 applications).

The original VEF traces are not redistributable; these generators reproduce
the *communication structure* the paper describes for each application and
are tuned so the network-activity signature matches the published timelines
(Fig 6/9/12/15) and inactivity histograms (Fig 1):

* LAMMPS:  startup bcast -> long setup compute -> iterations of {compute,
  P2P halo exchange, AllReduce (dominant), periodic FFT AlltoAll} -> reduce.
* PATMOS:  startup bcast -> one very long independent compute -> final
  AllReduce + Reduce (network touched only at the ends).
* MLWF:    Horovod training: per layer Gather + 2x Broadcast repeated, then
  a large AllReduce per step; near-continuous traffic.
* AlexNet: per-iteration forward compute, then per-layer backprop AllReduce
  bursts with real AlexNet layer parameter sizes; idle between bursts.

Allocations are a subset of the full-system nodes (default: linear mapping
from node 0), matching the paper's setup where the rest of the system idles.
"""
from __future__ import annotations

import numpy as np

from repro_torch.traffic import collectives as C
from repro_torch.traffic.trace import Trace


def allocate(topo, n, mapping="linear", seed=0):
    assert n <= topo.n_nodes
    if mapping == "linear":
        return np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(topo.n_nodes, n, replace=False)).astype(np.int64)


def lammps(topo, n_nodes=64, iters=40, scale=1.0, mapping="linear"):
    nodes = allocate(topo, n_nodes, mapping)
    t = Trace(nodes=nodes, name="lammps")
    t.rounds(C.broadcast(nodes, 1 << 20))              # model distribution
    t.compute(0.8 * scale)                             # setup (Fig 6: ~1 s)
    for i in range(iters):
        t.compute(20e-3 * scale)
        t.rounds(C.p2p_halo(nodes, 256 << 10))         # ghost-atom exchange
        t.compute(2e-3 * scale)
        t.rounds(C.allreduce(nodes, 64 << 10))         # dominant collective
        if i % 10 == 9:
            t.rounds(C.alltoall(nodes, 512 << 10))     # FFT long-range
    t.rounds(C.reduce(nodes, 1 << 20), barrier_last=True)
    return t


def patmos(topo, n_nodes=64, compute_secs=1285.0, mapping="linear"):
    nodes = allocate(topo, n_nodes, mapping)
    t = Trace(nodes=nodes, name="patmos")
    t.rounds(C.broadcast(nodes, 8 << 20))              # input decks
    t.compute(compute_secs)                            # independent MC batches
    t.rounds(C.allreduce(nodes, 1 << 20))              # global mean
    t.rounds(C.reduce(nodes, 1 << 20), barrier_last=True)   # variance
    return t


def mlwf(topo, n_nodes=64, steps=25, layers=8, mapping="linear"):
    nodes = allocate(topo, n_nodes, mapping)
    t = Trace(nodes=nodes, name="mlwf")
    t.rounds(C.broadcast(nodes, 16 << 20))             # initial weights
    for s in range(steps):
        for _ in range(layers):
            t.compute(1.5e-3)
            t.rounds(C.gather(nodes, 128 << 10))
            t.rounds(C.broadcast(nodes, 128 << 10))
            t.rounds(C.broadcast(nodes, 64 << 10))
        t.compute(30e-3)
        t.rounds(C.allreduce(nodes, 8 << 20))          # gradient exchange
    t.barrier()
    return t


# AlexNet parameter counts per gradient bucket (backprop order), bytes = 4*N
_ALEXNET_LAYERS = [4_097_000, 16_781_312, 37_752_832,
                   884_736, 1_327_104, 884_736, 614_656, 34_944]


def alexnet(topo, n_nodes=64, iters=10, mapping="linear"):
    nodes = allocate(topo, n_nodes, mapping)
    t = Trace(nodes=nodes, name="alexnet")
    t.rounds(C.broadcast(nodes, 244 << 20))            # weights
    for _ in range(iters):
        t.compute(0.5)                                 # forward + loss
        for p in _ALEXNET_LAYERS:
            t.compute(60e-3)                           # layer backward
            t.rounds(C.allreduce(nodes, 4 * p))        # gradient averaging
    t.barrier()
    return t


GENERATORS = {"lammps": lammps, "patmos": patmos, "mlwf": mlwf,
              "alexnet": alexnet}


def small_apps(topo, n_nodes=16):
    """Reduced versions of all four apps (tests / quick benches)."""
    return {
        "lammps": lammps(topo, n_nodes, iters=8),
        "patmos": patmos(topo, n_nodes, compute_secs=20.0),
        "mlwf": mlwf(topo, n_nodes, steps=4, layers=4),
        "alexnet": alexnet(topo, n_nodes, iters=2),
    }
