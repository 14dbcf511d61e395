"""MPI collective -> message-round expansion.

Ranks live in collective space; ``nodes[rank]`` maps to global node ids
(task mapping).  Algorithms follow standard MPI implementations:

* allreduce: recursive halving-doubling (reduce-scatter + all-gather),
  bandwidth-optimal for large payloads — 2*log2(n) rounds.
* broadcast: binomial tree, log2(n) rounds.
* reduce: reverse binomial tree.
* (all)gather: direct to root / ring.
* alltoall: Bruck, log2(n) rounds of n/2-relative exchanges.

Every function returns a list of (M,3) int64 arrays [src, dst, bytes] — one
per dependency round — suitable for Trace.rounds().
"""
from __future__ import annotations

import numpy as np


def _check(nodes):
    n = len(nodes)
    assert n >= 2 and (n & (n - 1)) == 0, \
        f"collectives require power-of-two participants, got {n}"
    return n


def _round(nodes, pairs_bytes):
    src, dst, b = zip(*pairs_bytes)
    return np.stack([nodes[np.asarray(src)], nodes[np.asarray(dst)],
                     np.asarray(b, np.int64)], axis=1)


def allreduce(nodes, nbytes):
    """Recursive halving-doubling: RS (sizes halve) then AG (sizes double)."""
    nodes = np.asarray(nodes)
    n = _check(nodes)
    logn = n.bit_length() - 1
    rounds = []
    size = nbytes
    # reduce-scatter
    for r in range(logn):
        size = max(size // 2, 1)
        peer = np.arange(n) ^ (1 << r)
        rounds.append(_round(nodes, [(i, int(peer[i]), size)
                                     for i in range(n)]))
    # all-gather
    for r in reversed(range(logn)):
        peer = np.arange(n) ^ (1 << r)
        rounds.append(_round(nodes, [(i, int(peer[i]), size)
                                     for i in range(n)]))
        size *= 2
    return rounds


def broadcast(nodes, nbytes, root=0):
    nodes = np.asarray(nodes)
    n = _check(nodes)
    logn = n.bit_length() - 1
    rounds = []
    vr = (np.arange(n) - root) % n  # virtual ranks, root -> 0
    inv = np.argsort(vr)
    # doubling: at round r only ranks vr < 2^r hold the data; each sends to
    # vr + 2^r, so the holder set doubles per round
    for r in range(logn):
        msgs = []
        for i in range(n):
            if vr[i] < (1 << r) and (vr[i] | (1 << r)) < n:
                msgs.append((i, int(inv[vr[i] | (1 << r)]), nbytes))
        if msgs:
            rounds.append(_round(nodes, msgs))
    return rounds


def reduce(nodes, nbytes, root=0):
    """Reverse binomial tree."""
    nodes = np.asarray(nodes)
    n = _check(nodes)
    logn = n.bit_length() - 1
    rounds = []
    vr = (np.arange(n) - root) % n
    inv = np.argsort(vr)
    # halving (mirror of broadcast): at round r every rank whose bit r is the
    # lowest set bit sends its accumulated partial to vr - 2^r and retires
    for r in range(logn):
        msgs = []
        for i in range(n):
            if vr[i] % (1 << (r + 1)) == (1 << r):
                msgs.append((i, int(inv[vr[i] - (1 << r)]), nbytes))
        if msgs:
            rounds.append(_round(nodes, msgs))
    return rounds


def gather(nodes, nbytes, root=0):
    """Direct gather: every rank sends its block to root (one round; the
    network serializes at the root link, as in reality)."""
    nodes = np.asarray(nodes)
    n = len(nodes)
    return [_round(nodes, [(i, root, nbytes) for i in range(n) if i != root])]


def allgather(nodes, nbytes):
    """Ring all-gather: n-1 rounds of neighbor exchanges."""
    nodes = np.asarray(nodes)
    n = len(nodes)
    return [_round(nodes, [(i, (i + 1) % n, nbytes) for i in range(n)])
            for _ in range(n - 1)]


def alltoall(nodes, nbytes_total):
    """Bruck: log2(n) rounds, each rank sends ~half its buffer 2^r away."""
    nodes = np.asarray(nodes)
    n = _check(nodes)
    logn = n.bit_length() - 1
    per_round = max(nbytes_total // 2, 1)
    rounds = []
    for r in range(logn):
        d = 1 << r
        rounds.append(_round(nodes, [(i, (i + d) % n, per_round)
                                     for i in range(n)]))
    return rounds


def p2p_halo(nodes, nbytes, dims=3):
    """Nearest-neighbor halo exchange on a pseudo-3D process grid
    (LAMMPS-style spatial decomposition): up to 2*dims neighbors each."""
    nodes = np.asarray(nodes)
    n = len(nodes)
    nx = max(int(round(n ** (1 / 3))), 1)
    ny = max(int(round((n // nx) ** 0.5)), 1) if n // nx else 1
    strides = [1, nx, nx * ny][:dims]
    msgs = []
    for s in strides:
        if s >= n:
            break
        for i in range(n):
            msgs.append((i, (i + s) % n, nbytes))
            msgs.append((i, (i - s) % n, nbytes))
    return [_round(nodes, msgs)]
