"""Template-free Cα-sequence alignment (protocol 'AF3_struct_free').

Re-implementation of the reference's seqStructureAlign / quasiSeqAlign /
findAlignedFrag (modeler.py:1053-1227): amino-acid evidence is diffused
across sequence offsets through the n-hop reachability matrix (a stack of
matmuls — MXU-shaped), then fragments are grown greedily from the
highest-scoring (sequence position, candidate) anchors, extending one
sequence position at a time through 0-7 A neighbors whose diffused score is
both that candidate's max over positions and above the score threshold.

Two passes: connect_len=5, then matched entries are boosted to 1 and the
diffusion re-run for connect_len=9.
"""

from __future__ import annotations

import logging
from typing import List, Sequence

import numpy as np

from .candidates import Candidates
from .nhop import n_hop_matrix, propagate_scores
from .types import AlignedFragment, SequenceEntry, build_seq_cand_aa_mat

logger = logging.getLogger(__name__)


class TemplateFreeAligner:
    def __init__(
        self,
        entries: Sequence[SequenceEntry],
        cands: Candidates,
        n_hop: int = 6,
        score_threshold: float = 2.0,
    ):
        self.entries = list(entries)
        self.cands = cands
        self.n_hop = n_hop
        self.score_threshold = score_threshold
        self.seq_cand_aa_mat = build_seq_cand_aa_mat(self.entries, cands.aa_prob)
        self.n_hop_mat = n_hop_matrix(cands.best_neigh, cands.neigh_mat, n_hop)
        self.aligned_frags: List[List[AlignedFragment]] = [[] for _ in self.entries]
        self.cand_match_result = np.zeros_like(self.seq_cand_aa_mat)
        self._working = self.seq_cand_aa_mat.copy()

    # ------------------------------------------------------------------
    def run(self) -> bool:
        """Both passes; False when no fragments can be aligned."""
        self._quasi_align(connect_len=5)
        if not any(self.aligned_frags):
            logger.error("template-free alignment: no fragments in pass 1")
            return False
        self._working[self.cand_match_result > 0] = 1.0
        self._quasi_align(connect_len=9)
        if not any(self.aligned_frags):
            logger.error("template-free alignment: no fragments in pass 2")
            return False
        for i, e in enumerate(self.entries):
            e.aligned_frags = self.aligned_frags[i]
        return True

    # ------------------------------------------------------------------
    def _quasi_align(self, connect_len: int) -> None:
        score = propagate_scores(self._working, self.n_hop_mat)
        self.seq_align_score = score
        self._working = self.seq_cand_aa_mat.copy()
        self.aligned_frags = [[] for _ in self.entries]
        self.cand_match_result = np.zeros_like(self.seq_cand_aa_mat)

        order = np.argsort(-score.max(axis=0).max(axis=0), kind="stable")
        used = set()
        found = 0
        for cand_ix in order:
            if cand_ix in used:
                continue
            fasta_ix, seq_ix = np.unravel_index(
                score[:, :, cand_ix].argmax(), score.shape[:2]
            )
            if score[fasta_ix, seq_ix, cand_ix] <= self.score_threshold:
                continue
            frag = self._grow_fragment(int(fasta_ix), int(seq_ix), int(cand_ix))
            if len(frag.trace) >= connect_len and np.mean(frag.scores) > self.score_threshold / 2:
                self.aligned_frags[fasta_ix].append(frag)
                found += 1
                n_chains = len(self.entries[fasta_ix].chains)
                for i, cand in enumerate(frag.trace):
                    used.add(cand)
                    pos = frag.seq_positions[i]
                    self.cand_match_result[fasta_ix, pos, cand] = frag.scores[i]
                    score[:, :, cand] = 0
                    self._working[:, :, cand] = 0
                    if np.sum(self.cand_match_result[fasta_ix, pos] > 0) >= n_chains:
                        score[fasta_ix, pos, :] = 0
                        self._working[fasta_ix, pos, :] = 0
        logger.info("quasi align (connect_len=%d): %d fragments", connect_len, found)

    # ------------------------------------------------------------------
    def _grow_fragment(self, fasta_ix: int, seq_ix: int, cand_ix: int) -> AlignedFragment:
        score = self.seq_align_score
        neigh_mat = self.cands.neigh_mat
        neighbors = self.cands.neighbors0to7
        seq_len = len(self.entries[fasta_ix])
        thr = self.score_threshold
        max_scores = score.max(axis=1)  # (n_fasta, n_cand)

        traces = [[cand_ix]]
        seqs = [[seq_ix]]
        scores = [[score[fasta_ix, seq_ix, cand_ix]]]
        left, right = seq_ix, seq_ix
        left_val, right_val = left > 0, right < seq_len - 1

        def best_branch(ts, ss, cs):
            sums = [np.sum(c) for c in cs]
            best = int(np.argmax(sums))
            if sums[best] <= 0:
                return ts, ss, cs
            return [ts[best]], [ss[best]], [cs[best]]

        while left_val or right_val:
            if left_val:
                left -= 1
                left_val = left > 0
                nt, ns, nc = [], [], []
                for i, trace in enumerate(traces):
                    for nb in neighbors[trace[0]]:
                        if score[fasta_ix, left, nb] == max_scores[fasta_ix, nb] > thr:
                            nt.append([nb] + trace)
                            ns.append([left] + seqs[i])
                            nc.append(
                                [neigh_mat[nb, trace[0]] * score[fasta_ix, left, nb]]
                                + scores[i]
                            )
                if not nt:
                    left_val = False
                    left += 1
                else:
                    traces, seqs, scores = (
                        best_branch(nt, ns, nc) if len(nt) > 1 else (nt, ns, nc)
                    )

            if right_val:
                right += 1
                right_val = right < seq_len - 1
                nt, ns, nc = [], [], []
                for i, trace in enumerate(traces):
                    for nb in neighbors[trace[-1]]:
                        if score[fasta_ix, right, nb] == max_scores[fasta_ix, nb] > thr:
                            nt.append(trace + [nb])
                            ns.append(seqs[i] + [right])
                            nc.append(
                                scores[i]
                                + [neigh_mat[trace[-1], nb] * score[fasta_ix, right, nb]]
                            )
                if not nt:
                    right_val = False
                    right -= 1
                else:
                    traces, seqs, scores = (
                        best_branch(nt, ns, nc) if len(nt) > 1 else (nt, ns, nc)
                    )

        sums = [np.sum(c) for c in scores]
        best = int(np.argmax(sums))
        if sums[best] > 0:
            return AlignedFragment(traces[best], seqs[best], np.asarray(scores[best]))
        return AlignedFragment([], [], np.zeros(0))
