"""Megafly topology + deterministic minimal routing (the paper's scenario).

Paper scenario (§4): 65 groups x 64 nodes = 4160 nodes.  Each group is a
two-level bipartite graph of 16 radix-16 switches: 8 leaves (8 down-links to
nodes, 8 up-links to spines) and 8 spines (8 down-links to leaves, 8 global
ports).  Every pair of groups is connected by exactly one global link
(65 groups x 64 global ports / 2 = 2080 global links).

Link inventory (undirected): 4160 node links + 65*64 leaf-spine links +
2080 global links = 10400 links = 20800 port-ends (matches Table 5).

Routing is deterministic minimal, D-mod-k style: the up-path spine for an
intra-group packet is ``dst % spines``; for inter-group packets the spine is
forced by the unique global link to the destination group.  Hop counts
(links traversed): same-leaf 2, intra-group 4, inter-group 5.

Everything here is host-side numpy — the replay expands each step's paths
through ``routes`` and feeds the device as plain index tensors.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from repro_torch.topology.base import RoutedTopology


@dataclasses.dataclass(frozen=True)
class Megafly(RoutedTopology):
    n_groups: int = 65
    leaves_per_group: int = 8
    spines_per_group: int = 8
    nodes_per_leaf: int = 8

    # ---- derived sizes ---------------------------------------------------
    @property
    def nodes_per_group(self) -> int:
        return self.leaves_per_group * self.nodes_per_leaf

    @property
    def n_nodes(self) -> int:
        return self.n_groups * self.nodes_per_group

    @property
    def switches_per_group(self) -> int:
        return self.leaves_per_group + self.spines_per_group

    @property
    def n_switches(self) -> int:
        return self.n_groups * self.switches_per_group

    @property
    def radix(self) -> int:
        return self.nodes_per_leaf + self.spines_per_group

    @property
    def n_node_links(self) -> int:
        return self.n_nodes

    @property
    def n_ls_links(self) -> int:  # leaf-spine
        return self.n_groups * self.leaves_per_group * self.spines_per_group

    @property
    def n_global_links(self) -> int:
        return self.n_groups * (self.n_groups - 1) // 2

    @property
    def n_links(self) -> int:
        return self.n_node_links + self.n_ls_links + self.n_global_links

    @property
    def n_ports(self) -> int:  # port-ends, the paper's "links" count
        return 2 * self.n_links

    @property
    def max_hops(self) -> int:
        return 5

    # ---- link ids ---------------------------------------------------------
    def node_link(self, n):
        return np.asarray(n)

    def ls_link(self, g, leaf, spine):
        return (self.n_node_links
                + (np.asarray(g) * self.leaves_per_group + np.asarray(leaf))
                * self.spines_per_group + np.asarray(spine))

    def global_link(self, g, h):
        g, h = np.asarray(g), np.asarray(h)
        lo, hi = np.minimum(g, h), np.maximum(g, h)
        G = self.n_groups
        # index into the upper-triangular pair list
        idx = lo * G - lo * (lo + 1) // 2 + (hi - lo - 1)
        return self.n_node_links + self.n_ls_links + idx

    def peer_port(self, g, h):
        """Global-port index (0..63) used by group g to reach group h."""
        g, h = np.asarray(g), np.asarray(h)
        return np.where(h < g, h, h - 1)

    def global_spine(self, g, h):
        """Spine in group g owning the global link to group h."""
        return self.peer_port(g, h) // self.spines_per_group

    # ---- node coordinates --------------------------------------------------
    def node_group(self, n):
        return np.asarray(n) // self.nodes_per_group

    def node_leaf(self, n):
        return (np.asarray(n) % self.nodes_per_group) // self.nodes_per_leaf

    # ---- routing ------------------------------------------------------------
    def routes(self, src, dst):
        """Vectorized minimal deterministic routing.

        src, dst: int arrays (M,).  Returns (links (M, max_hops) int32 with -1
        padding, n_hops (M,) int32).  Directions are implicit: direction bit =
        position parity is NOT valid here, so we also return dirs (M, max_hops)
        in {0,1}: 0 = lower-id endpoint transmits, 1 = higher-id endpoint.
        For power accounting only the link id matters; for serialization we
        track per-direction occupancy = 2*link + dir.
        """
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        M = src.shape[0]
        H = self.max_hops
        links = np.full((M, H), -1, np.int64)
        dirs = np.zeros((M, H), np.int64)

        gs, gd = self.node_group(src), self.node_group(dst)
        ls, ld = self.node_leaf(src), self.node_leaf(dst)
        same = src == dst
        same_leaf = (~same) & (gs == gd) & (ls == ld)
        intra = (~same) & (gs == gd) & (ls != ld)
        inter = gs != gd

        nl_s = self.node_link(src)      # node -> leaf (up: dir 0)
        nl_d = self.node_link(dst)      # leaf -> node (down: dir 1)

        # same leaf: [src->leaf, leaf->dst]
        links[same_leaf, 0] = nl_s[same_leaf]
        links[same_leaf, 1] = nl_d[same_leaf]
        dirs[same_leaf, 0] = 0
        dirs[same_leaf, 1] = 1

        # intra group: spine by D-mod-k on destination node id
        sp = dst % self.spines_per_group
        up = self.ls_link(gs, ls, sp)
        dn = self.ls_link(gd, ld, sp)
        for (m, arr, d) in ((0, nl_s, 0), (1, up, 0), (2, dn, 1), (3, nl_d, 1)):
            links[intra, m] = arr[intra]
            dirs[intra, m] = d

        # inter group: forced spine on both sides of the global link
        sp_s = self.global_spine(gs, gd)
        sp_d = self.global_spine(gd, gs)
        up_i = self.ls_link(gs, ls, sp_s)
        gl = self.global_link(gs, gd)
        gdir = np.where(gs < gd, 0, 1)
        dn_i = self.ls_link(gd, ld, sp_d)
        for (m, arr, d) in ((0, nl_s, 0), (1, up_i, 0), (2, gl, None),
                            (3, dn_i, 1), (4, nl_d, 1)):
            links[inter, m] = arr[inter]
            dirs[inter, m] = gdir[inter] if d is None else d

        n_hops = np.where(same, 0,
                          np.where(same_leaf, 2, np.where(intra, 4, 5)))
        return links.astype(np.int32), dirs.astype(np.int32), \
            n_hops.astype(np.int32)

    def hop_distance(self, src, dst):
        return self.routes(np.atleast_1d(src), np.atleast_1d(dst))[2]


def paper_topology() -> Megafly:
    """The exact §4 scenario: 4160 nodes, 1040 switches, 20800 port-ends."""
    return Megafly()


def small_topology(n_groups=5, leaves=4, spines=4, nodes_per_leaf=4) -> Megafly:
    """A reduced Megafly for tests/benchmarks (same structure)."""
    return Megafly(n_groups=n_groups, leaves_per_group=leaves,
                   spines_per_group=spines, nodes_per_leaf=nodes_per_leaf)
