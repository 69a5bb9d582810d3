"""AF3-template Cα-sequence alignment (protocol 'AF3_struct').

Re-implementation of the reference's seqStructScoring / registerScoring /
registerExpand / seqStructAlignWithAF3Structure stack
(modeler.py:206-292, 1229-1434, 1436-1494).

The reference fans these out over fork pools with a module-global
blackboard; here the hot parts are batched:

  * local-trace vs AF3-window RMSD scoring runs as one batched Kabsch over
    the (sequence-window x local-trace) cross product (blocked to bound
    memory) instead of one fork-pool task per window;
  * register scoring's per-anchor rigid fits use the batched Kabsch too.

Everything downstream consumes the same quantities the reference computes:
``struct_match`` / ``seq_struct_align_score`` (n-hop-diffused), per-anchor
register scores (CA-probability integral of the transformed template), and
the greedy chain assembly with its expansion thresholds.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence

import numpy as np

from ..ops.kabsch import rmsd_batch, superpose
from .candidates import Candidates
from .sparse import SparseHopMatrix
from .nhop import n_hop_matrix, propagate_scores
from .types import AlignedFragment, SequenceEntry, build_seq_cand_aa_mat

logger = logging.getLogger(__name__)


def local_traces(cands: Candidates, struct_len: int = 5,
                 min_edge_score: float = 0.7) -> List[List[int]]:
    """Beam all best-neighbor walks of length ``struct_len``; keep the best
    trace per (start, endpoint) whose mean edge score exceeds the cutoff
    (modeler.py:1380-1399)."""
    out: List[List[int]] = []
    for start in range(len(cands)):
        traces = [[start]]
        scores = [0.0]
        for _ in range(struct_len - 1):
            nt, ns = [], []
            for trace, sc in zip(traces, scores):
                for nb in cands.best_neigh[trace[-1]]:
                    if nb in trace:
                        continue
                    nt.append(trace + [nb])
                    ns.append(sc + cands.neigh_mat[trace[-1], nb])
            traces, scores = nt, ns
        best = {}
        for trace, sc in zip(traces, scores):
            if sc / (struct_len - 1) > min_edge_score:
                end = trace[-1]
                if end not in best or sc > best[end][1]:
                    best[end] = (trace, sc)
        out.extend(t for t, _ in best.values())
    return out


@dataclasses.dataclass
class AF3AlignState:
    entries: List[SequenceEntry]
    cands: Candidates
    seq_cand_aa_mat: np.ndarray  # (F, L, N)
    n_hop_mat: "SparseHopMatrix | np.ndarray"
    seq_struct_align_score: Optional[np.ndarray] = None
    register_scores: Optional[List[float]] = None


class AF3Aligner:
    def __init__(
        self,
        entries: Sequence[SequenceEntry],
        cands: Candidates,
        ca_prob: np.ndarray,
        n_hop: int = 6,
        struct_len: int = 5,
        neigh_mat_threshold: float = 0.7,
        batch_block: int = 65536,
    ):
        self.entries = list(entries)
        self.cands = cands
        self.ca_prob = ca_prob
        self.n_hop = n_hop
        self.struct_len = struct_len
        self.neigh_mat_threshold = float(neigh_mat_threshold)
        self.batch_block = batch_block
        self.seq_cand_aa_mat = build_seq_cand_aa_mat(self.entries, cands.aa_prob)
        self.n_hop_mat = n_hop_matrix(cands.best_neigh, cands.neigh_mat, n_hop)
        self.seq_struct_align_score: Optional[np.ndarray] = None
        self.register_scores: List[float] = []
        self.aligned_frags: List[List[AlignedFragment]] = [[] for _ in self.entries]

    # ------------------------------------------------------------------
    # stage 1: struct_match + diffusion
    # ------------------------------------------------------------------
    def struct_scoring(self) -> None:
        """Batched equivalent of seqStructScoring (modeler.py:1372-1434)."""
        traces = local_traces(self.cands, self.struct_len,
                              min_edge_score=self.neigh_mat_threshold)
        if not traces:
            raise RuntimeError("no local traces — candidate graph too sparse")
        logger.info("local traces: %d", len(traces))
        trace_arr = np.asarray(traces)  # (T, K)
        t_count, k = trace_arr.shape

        # per-trace neighbor score mean (T,)
        nei = self.cands.neigh_mat[trace_arr[:, :-1], trace_arr[:, 1:]].mean(axis=1)
        trace_coords = self.cands.coords[trace_arr]  # (T, K, 3)

        struct_match = np.zeros_like(self.seq_cand_aa_mat)
        for f, entry in enumerate(self.entries):
            af3 = entry.af3_coords
            if af3 is None:
                continue
            n_win = len(entry) - k + 1
            if n_win <= 0:
                continue
            win_pos = np.arange(n_win)[:, None] + np.arange(k)[None, :]  # (W, K)
            # AA score (W, T): mean over k of
            # seq_cand_aa_mat[f, win_pos[w, i], trace_arr[t, i]]
            aa_score = np.stack(
                [
                    self.seq_cand_aa_mat[f][win_pos[:, i]][:, trace_arr[:, i]]
                    for i in range(k)
                ],
                axis=0,
            ).mean(axis=0)

            af3_wins = af3[win_pos]  # (W, K, 3)
            # batched RMSD over the (W x T) cross product, blocked
            rmsd = np.empty((n_win, t_count))
            block = max(1, self.batch_block // max(t_count, 1))
            for w0 in range(0, n_win, block):
                w1 = min(n_win, w0 + block)
                tgt = np.repeat(trace_coords[None], w1 - w0, axis=0).reshape(-1, k, 3)
                mob = np.repeat(af3_wins[w0:w1, None], t_count, axis=1).reshape(-1, k, 3)
                rmsd[w0:w1] = rmsd_batch(tgt, mob).reshape(w1 - w0, t_count)

            score = aa_score + nei[None, :] - np.minimum(
                1.0, np.maximum(0.0, rmsd - 1.0)
            ) ** 2  # (W, T)

            # scatter-max into struct_match[f, win_pos[w,i], trace_arr[t,i]]
            for i in range(k):
                pos = win_pos[:, i]  # (W,)
                cs = trace_arr[:, i]  # (T,)
                flat = struct_match[f]
                np.maximum.at(
                    flat,
                    (np.repeat(pos, t_count), np.tile(cs, n_win)),
                    score.ravel(),
                )

        struct_match[struct_match < 0.1] = 0.1
        self.seq_struct_align_score = propagate_scores(struct_match, self.n_hop_mat)
        logger.info("struct scoring done")

    # ------------------------------------------------------------------
    # stage 2: register scoring per anchor position
    # ------------------------------------------------------------------
    def register_anchor(self, fasta_ix: int, seq_ix: int, radius: int,
                        score: np.ndarray):
        """Anchor the template at one sequence position (modeler.py:206-292).

        Returns a list of [CA-integral score, trace, seq range, transformed
        AF3 window coords], deduplicated at 8 A, capped at 3x chain count.
        """
        entry = self.entries[fasta_ix]
        af3 = entry.af3_coords
        this_seq = list(range(seq_ix - radius, seq_ix + radius + 1))
        af3_split = af3[this_seq]
        chain_num = len(entry.chains)
        neigh = self.cands.neighbors2to6

        row = score[fasta_ix, seq_ix]
        cand_set = np.where(row > row.max() * 0.85)[0]
        items, raw_scores = [], []
        for cand in cand_set:
            trace = [int(cand)]
            ok = True
            for i in range(radius):
                # grow right at seq_ix+1+i
                mean_r = score[fasta_ix, seq_ix + 1 + i].mean()
                best_s, best_n = -1.0, -1
                for nb in set(neigh[trace[-1]]) - set(trace):
                    s = score[fasta_ix, seq_ix + 1 + i, nb]
                    if s > best_s:
                        best_s, best_n = s, nb
                if best_s > mean_r:
                    trace = trace + [best_n]
                else:
                    ok = False
                    break
                # grow left at seq_ix-1-i
                mean_l = score[fasta_ix, seq_ix - 1 - i].mean()
                best_s, best_n = -1.0, -1
                for nb in set(neigh[trace[0]]) - set(trace):
                    s = score[fasta_ix, seq_ix - 1 - i, nb]
                    if s > best_s:
                        best_s, best_n = s, nb
                if best_s > mean_l:
                    trace = [best_n] + trace
                else:
                    ok = False
                    break
            if not ok or not trace:
                continue
            coords = self.cands.coords[trace]
            _, r, t = superpose(coords, af3_split)
            new_af3 = af3 @ r.T + t
            items.append((trace, new_af3[this_seq]))
            raw_scores.append(self._ca_integral(new_af3))

        results = []
        if raw_scores:
            for ix in np.argsort(raw_scores)[::-1]:
                trace, win = items[ix]
                coords = self.cands.coords[trace]
                if len(results) >= 3 * chain_num:
                    break
                if all(
                    np.sqrt(np.sum((res[3] - coords) ** 2, axis=1)).mean() >= 8
                    for res in results
                ):
                    results.append([raw_scores[ix], trace, this_seq, win])
        return results

    def _ca_integral(self, transformed_af3: np.ndarray) -> float:
        """Sum of CA probability at the transformed template's voxels."""
        pts = np.rint(transformed_af3).astype(np.int64)
        shape = np.asarray(self.ca_prob.shape)
        ok = np.all((pts >= 0) & (pts < shape), axis=1)
        pts = pts[ok]
        return float(np.sum(self.ca_prob[pts[:, 0], pts[:, 1], pts[:, 2]]))

    def register_scoring_pass(self, score: np.ndarray):
        """All anchor positions for all sequences; yields per-seq results."""
        radius = self.struct_len // 2 + 1
        all_results = []
        for f, entry in enumerate(self.entries):
            seq_results = []
            if entry.af3_coords is not None:
                for seq_ix in range(radius, len(entry) - radius - 1):
                    seq_results.append(
                        (seq_ix, self.register_anchor(f, seq_ix, radius, score))
                    )
            all_results.append(seq_results)
        return all_results

    def compute_register_scores(self) -> None:
        """registerScores per sequence (modeler.py:1331-1370)."""
        if self.seq_struct_align_score is None:
            self.struct_scoring()
        score = self.seq_struct_align_score.copy()
        self._register_results = self.register_scoring_pass(score)
        self.register_scores = []
        for f, entry in enumerate(self.entries):
            chain_num = len(entry.chains)
            best = 0.0
            for _, res in self._register_results[f]:
                if len(res) >= chain_num and res[chain_num - 1][0] > best:
                    best = res[chain_num - 1][0]
            self.register_scores.append(best)
            logger.info("register score %s: %.2f", entry.name, best)

    # ------------------------------------------------------------------
    # stage 3: register expansion
    # ------------------------------------------------------------------
    def register_expand(self, chains, fasta_ix: int):
        """Extend anchored registers while the rigid fit holds
        (modeler.py:1436-1494)."""
        entry = self.entries[fasta_ix]
        af3 = entry.af3_coords
        seq_len = len(entry)
        coords_all = self.cands.coords
        order = np.argsort([c[0] for c in chains])[::-1]
        results = []
        for j in order:
            _, trace, seq, _ = chains[j]
            trace = list(trace)
            left, right = seq[0], seq[-1]
            left_val, right_val = left > 0, right < seq_len - 1
            while left_val or right_val:
                if left_val:
                    check = min(len(trace), 20)
                    rmsd, r, t = superpose(coords_all[trace[:check]], af3[left : left + check])
                    trans = af3 @ r.T + t
                    d = np.sqrt(np.sum((coords_all - trans[left - 1]) ** 2, axis=1))
                    if rmsd < 5 and d.min() < 3:
                        left -= 1
                        trace = [int(d.argmin())] + trace
                        left_val = left > 0
                    else:
                        left_val = False
                if right_val:
                    check = min(len(trace), 20)
                    rmsd, r, t = superpose(
                        coords_all[trace[-check:]], af3[right - check + 1 : right + 1]
                    )
                    trans = af3 @ r.T + t
                    d = np.sqrt(np.sum((coords_all - trans[right + 1]) ** 2, axis=1))
                    if rmsd < 5 and d.min() < 3:
                        right += 1
                        trace = trace + [int(d.argmin())]
                        right_val = right < seq_len - 1
                    else:
                        right_val = False
            this_seq = list(range(left, right + 1))
            _, r, t = superpose(coords_all[trace], af3[this_seq])
            results.append([this_seq, trace, self._ca_integral(af3 @ r.T + t)])
        return results

    # ------------------------------------------------------------------
    # stage 4: global assembly
    # ------------------------------------------------------------------
    def run(self) -> None:
        """Full AF3 alignment (modeler.py:1229-1329)."""
        self.compute_register_scores()
        score_copy = self.seq_struct_align_score.copy()
        used_cand: set = set()
        cand_match = np.zeros_like(self.seq_cand_aa_mat)

        for fasta_ix in np.argsort(self.register_scores)[::-1]:
            entry = self.entries[fasta_ix]
            if entry.af3_coords is None:
                continue
            seq_len = len(entry)
            chain_num = len(entry.chains)
            logger.info("assembling %s (%d res, %d chains)", entry.name, seq_len, chain_num)

            af3_scores = []
            score_mat = np.zeros(self.seq_struct_align_score.shape[1:])
            for _, result in self._register_results[fasta_ix]:
                if len(result) >= chain_num:
                    chains = self.register_expand(result, fasta_ix)
                    scores = [c[2] for c in chains]
                    af3_scores.append(scores[np.argsort(scores)[-chain_num]])
                    for this_seq, this_trace, s in chains:
                        score_mat[this_seq, this_trace] += s
            if not af3_scores or np.sum(af3_scores) == 0:
                logger.warning("no AF3 matches for %s", entry.name)
                continue

            top = np.unravel_index(
                score_mat.argsort(axis=None)[::-1][: 3 * chain_num * seq_len],
                score_mat.shape,
            )
            for i, cand in enumerate(top[1]):
                cand = int(cand)
                if cand in used_cand:
                    continue
                seq_ix = int(top[0][i])
                trace = [cand]
                left = seq_ix
                while left > 0:
                    best_s, best_n = 0.0, -1
                    for nb in set(self.cands.neighbors2to6[trace[0]]) - used_cand:
                        v = self.cands.neigh_mat[trace[0], nb] * score_mat[left - 1, nb]
                        if v > best_s and score_mat[left - 1, nb] > 0.9 * score_mat[:, nb].max():
                            best_s, best_n = v, nb
                    if best_s > 100:
                        trace = [int(best_n)] + trace
                        left -= 1
                    else:
                        break
                right = seq_ix
                while right < seq_len - 1:
                    best_s, best_n = 100.0, -1
                    for nb in set(self.cands.neighbors2to6[trace[-1]]) - used_cand:
                        v = self.cands.neigh_mat[trace[-1], nb] * score_mat[right + 1, nb]
                        if v > best_s and score_mat[right + 1, nb] > 0.9 * score_mat[:, nb].max():
                            best_s, best_n = v, nb
                    if best_s > 100:
                        trace = trace + [int(best_n)]
                        right += 1
                    else:
                        break
                if len(trace) < 20:
                    continue
                this_seq = list(range(left, right + 1))[3:-3]
                trace = trace[3:-3]
                cand_match[fasta_ix, this_seq, trace] = 1
                score_mat[np.where(cand_match[fasta_ix].sum(axis=1) >= chain_num)] = 0
                used_cand.update(trace)
                self.aligned_frags[fasta_ix].append(
                    AlignedFragment(
                        trace, this_seq,
                        self.seq_struct_align_score[fasta_ix, this_seq, trace],
                    )
                )
        for i, e in enumerate(self.entries):
            e.aligned_frags = self.aligned_frags[i]
