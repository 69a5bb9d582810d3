"""Backbone fragment extraction from the candidate neighbor graph.

Re-implementation of the reference's fragModeling (modeler.py:901-1014):
prune the 2-6 A neighbor graph (weakest edges first) until every node has
degree <= 2, peel linear fragments from terminal nodes, break remaining
cycles at their weakest edge, then greedily merge nearest fragment
endpoints until at most min(62, N / frags_len + 1) fragments remain.

(The reference computes but never stores its fragments — SURVEY.md flags
them as vestigial EModelX output.  They are returned here because fragment
lists are useful for diagnostics and template-free seeding.)
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np

from .candidates import Candidates

logger = logging.getLogger(__name__)


def build_fragments(cands: Candidates, frags_len: int = 150) -> List[List[int]]:
    import networkx as nx

    graph = nx.Graph()
    edges = []
    for cand in range(len(cands)):
        for nb in cands.neighbors2to6[cand]:
            if nb > cand:
                graph.add_edge(cand, int(nb))
                edges.append((cands.neigh_mat[cand, nb], cand, int(nb)))
    if not edges:
        return []

    # prune: remove weakest edges joining two degree>2 nodes
    edges.sort(key=lambda e: e[0])
    survivors = []
    for w, a, b in edges:
        if graph.degree(a) > 2 and graph.degree(b) > 2:
            graph.remove_edge(a, b)
        else:
            survivors.append((w, a, b))
    survivors.sort(key=lambda e: e[0])
    for w, a, b in survivors:
        if graph.has_edge(a, b) and (graph.degree(a) > 2 or graph.degree(b) > 2):
            graph.remove_edge(a, b)

    # peel linear fragments from terminals
    fragments: List[List[int]] = []
    tmp = graph.copy()

    def peel(node):
        nxt = next(iter(tmp[node]))
        frag = [node, nxt]
        tmp.remove_edge(node, nxt)
        while tmp.degree(nxt) == 1:
            nb = next(iter(tmp[nxt]))
            frag.append(nb)
            tmp.remove_edge(nxt, nb)
            nxt = nb
        fragments.append(frag)

    for node in list(graph.nodes):
        if tmp.degree(node) == 1:
            peel(node)

    # break remaining cycles at their weakest edge
    while tmp.number_of_edges() > 0:
        weakest = min(tmp.edges(), key=lambda e: cands.neigh_mat[e[0], e[1]])
        a, b = weakest
        tmp.remove_edge(a, b)
        if tmp.degree(a) == 1:
            peel(a)

    logger.info("initial fragments: %d", len(fragments))

    # merge nearest endpoints down to the cap
    max_frags = min(62, len(cands) // frags_len + 1)
    while len(fragments) > max_frags and len(fragments) > 1:
        nf = len(fragments)
        dmap = np.full((2 * nf, 2 * nf), 1e4)
        for i, f1 in enumerate(fragments):
            for j, f2 in enumerate(fragments):
                if i == j:
                    continue
                dmap[2 * i, 2 * j] = cands.dist[f1[0], f2[0]]
                dmap[2 * i + 1, 2 * j] = cands.dist[f1[-1], f2[0]]
                dmap[2 * i, 2 * j + 1] = cands.dist[f1[0], f2[-1]]
                dmap[2 * i + 1, 2 * j + 1] = cands.dist[f1[-1], f2[-1]]
        bi, bj = np.unravel_index(dmap.argmin(), dmap.shape)
        i, j = bi // 2, bj // 2
        left = fragments[i] if bi % 2 == 1 else fragments[i][::-1]
        right = fragments[j] if bj % 2 == 0 else fragments[j][::-1]
        merged = list(left) + list(right)
        for ix in sorted((i, j), reverse=True):
            del fragments[ix]
        fragments.append(merged)

    logger.info("final fragments: %d", len(fragments))
    return fragments
