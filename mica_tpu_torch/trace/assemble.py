"""Chain assembly: initial model building and gap filling.

Re-implementation of the reference's initialModelBuilding / gapFilling /
fillGap (modeler.py:1496-2123): aligned fragments are distributed over the
copies of each sequence (chains) by a beam search over assignment
hypotheses, scored by inter-fragment rigid-fit RMSD (vs already-assigned
chains and, under the AF3 protocol, vs the template); remaining gaps are
filled by a bidirectional beam search over the candidate neighbor graph
scored by the n-hop-diffused per-chain candidate matrix, with a symmetry
(rigid-fit) penalty; conflicts where one candidate lands in several chains
resolve by chain-centroid distance.
"""

from __future__ import annotations

import copy
import logging
from typing import Dict, List, Sequence, Set

import numpy as np

from ..ops.kabsch import superpose
from .candidates import Candidates
from .sparse import SparseHopMatrix
from .nhop import propagate_scores
from .types import SequenceEntry

logger = logging.getLogger(__name__)

BEAM_LIMIT = 1000
BEAM_KEEP = 10


class Assembler:
    def __init__(
        self,
        entries: Sequence[SequenceEntry],
        cands: Candidates,
        seq_cand_aa_mat: np.ndarray,
        n_hop_mat: "SparseHopMatrix | np.ndarray",
        protocol: str = "AF3_struct",
    ):
        self.entries = list(entries)
        self.cands = cands
        self.seq_cand_aa_mat = seq_cand_aa_mat
        self.n_hop_mat = n_hop_mat
        self.protocol = protocol
        self.used_cands: Set[int] = set()

    # ==================================================================
    # initial model building
    # ==================================================================
    def build_initial_model(self) -> None:
        for fasta_ix, entry in enumerate(self.entries):
            frags = entry.aligned_frags
            traces = [f.trace for f in frags]
            seqs = [f.seq_positions for f in frags]
            trace_scores = []
            for f in frags:
                aa = self.seq_cand_aa_mat[fasta_ix, f.seq_positions, f.trace]
                nei = self.cands.neigh_mat[f.trace[:-1], f.trace[1:]]
                trace_scores.append((aa[1:] + aa[:-1]) * nei)

            if not frags:
                continue
            chain_ids = list(entry.chains.keys())
            model = self._assemble_chains(
                entry, fasta_ix, traces, seqs, trace_scores, chain_ids
            )

            # apply fragments per chain, low scores first so high overwrite
            for chain_id, frag_ids in model.items():
                order = np.argsort([np.sum(trace_scores[i]) for i in frag_ids])
                for oi in order:
                    ix = frag_ids[oi]
                    for c, cand in enumerate(traces[ix][3:-3]):
                        p = seqs[ix][3:-3][c]
                        entry.chains[chain_id].result[p] = cand
                for cand in entry.chains[chain_id].result:
                    if cand != -1:
                        self.used_cands.add(int(cand))

    # ------------------------------------------------------------------
    def _assemble_chains(self, entry, fasta_ix, traces, seqs, trace_scores,
                         chain_ids) -> Dict[str, List[int]]:
        """Beam search assigning fragments to chain copies."""
        seq_len = len(entry)
        n_frags = len(traces)
        unused = set(range(n_frags))

        # per-position coverage, scored
        pos_scores = np.zeros(seq_len)
        pos_frags: List[List[int]] = [[] for _ in range(seq_len)]
        for s in range(n_frags):
            seq_arr = seqs[s]
            base = np.sum(trace_scores[s])
            for p in seq_arr:
                frac = (p - seq_arr[0]) / max(len(seq_arr), 1)
                pos_scores[p] += base + 2 * frac * (1 - frac)
                pos_frags[p].append(s)
        # order fragments at each position by score desc
        for p in range(seq_len):
            pos_frags[p].sort(key=lambda s: -np.sum(trace_scores[s]))

        anchor = int(np.argmax(pos_scores))
        model: Dict[str, List[int]] = {}
        for s in pos_frags[anchor]:
            if len(model) < len(chain_ids):
                model[chain_ids[len(model)]] = [s]
                unused.discard(s)
        models = [model]

        left, right = anchor, anchor
        while True:
            new_models = []
            placed = None
            for trace_id in sorted(unused):
                sset = seqs[trace_id]
                at_left = left in sset
                at_right = right in sset
                if not (at_left or at_right):
                    continue
                placed = trace_id
                prepend = at_left
                if len(models[0]) < len(chain_ids):
                    models[0][chain_ids[len(models[0])]] = [trace_id]
                    new_models = []
                    break
                for m in models:
                    new_models.extend(
                        self._branch_assign(
                            entry, fasta_ix, m, trace_id, traces, seqs,
                            chain_ids, prepend,
                        )
                    )
                break

            if placed is not None:
                unused.discard(placed)
            if new_models:
                if len(new_models) > BEAM_LIMIT:
                    scores = [
                        self._model_dispersion(m, traces, seqs) for m in new_models
                    ]
                    keep = np.argsort(scores)[:BEAM_KEEP]
                    models = [new_models[i] for i in keep]
                else:
                    models = new_models
            elif placed is None:
                if left > -1 or right < seq_len:
                    if left > -1:
                        left -= 1
                    if right < seq_len:
                        right += 1
                else:
                    break
            if left <= -1 and right >= seq_len and not unused:
                break
            if left <= -1 and right >= seq_len and placed is None:
                break

        best = int(np.argmin([self._model_dispersion(m, traces, seqs) for m in models]))
        return models[best]

    def _branch_assign(self, entry, fasta_ix, model, trace_id, traces, seqs,
                       chain_ids, prepend: bool):
        """Branch hypotheses for assigning one fragment to a chain."""
        sset = set(seqs[trace_id])
        matched = set()
        for chain_id, frag_ids in model.items():
            for ti in frag_ids:
                if len(sset & set(seqs[ti])) > 4:
                    matched.add(chain_id)
        unmatched = [c for c in chain_ids if c not in matched]
        if not unmatched:
            return [copy.deepcopy(model)]

        use_af3 = self.protocol == "AF3_struct"
        if use_af3 or matched:
            seq_len = len(entry)
            occ_lists = []
            for chain_id in matched:
                occ = np.full(seq_len, -1, np.int64)
                for ti in model[chain_id]:
                    occ[seqs[ti]] = traces[ti]
                occ_lists.append(occ)
            val_lists = []
            for chain_id in unmatched:
                val = np.full(seq_len, -1, np.int64)
                for ti in model[chain_id]:
                    val[seqs[ti]] = traces[ti]
                val[seqs[trace_id]] = traces[trace_id]
                val_lists.append(val)

            rows = len(matched) + (1 if use_af3 else 0)
            rmsd = np.full((rows, len(unmatched)), 1e4)
            for j in range(len(unmatched)):
                for i in range(len(matched)):
                    both = (occ_lists[i] != -1) & (val_lists[j] != -1)
                    if both.sum() >= 3:
                        rmsd[i, j] = superpose(
                            self.cands.coords[val_lists[j][both]],
                            self.cands.coords[occ_lists[i][both]],
                        )[0]
                if use_af3:
                    has = val_lists[j] != -1
                    if has.sum() >= 3:
                        rmsd[-1, j] = superpose(
                            self.cands.coords[val_lists[j][has]],
                            entry.af3_coords[np.where(has)[0]],
                        )[0]
            _, min_j = np.unravel_index(np.argmin(rmsd), rmsd.shape)
            out = copy.deepcopy(model)
            if prepend:
                out[unmatched[min_j]] = [trace_id] + out[unmatched[min_j]]
            else:
                out[unmatched[min_j]] = out[unmatched[min_j]] + [trace_id]
            return [out]

        # template-free, nothing matched: branch over all chains
        outs = []
        for chain_id in unmatched:
            out = copy.deepcopy(model)
            out[chain_id] = (
                [trace_id] + out[chain_id] if prepend else out[chain_id] + [trace_id]
            )
            outs.append(out)
        return outs

    def _model_dispersion(self, model, traces, seqs) -> float:
        """Gap-consistency metric for beam collapse (modeler.py:1693-1705)."""
        dis = []
        for frag_ids in model.values():
            for i in range(len(frag_ids) - 1):
                c1 = traces[frag_ids[i]][-1]
                c2 = traces[frag_ids[i + 1]][0]
                s1 = seqs[frag_ids[i]][-1]
                s2 = seqs[frag_ids[i + 1]][0]
                sp = self.cands.dist[c1, c2]
                sd = abs(s2 - s1)
                dis.append(np.sqrt(sd) + sp + sp / (sd + 1))
        return float(np.mean(dis)) if dis else 0.0

    # ==================================================================
    # gap filling
    # ==================================================================
    def fill_gaps(self) -> None:
        for fasta_ix, entry in enumerate(self.entries):
            chain_ids = list(entry.chains.keys())
            n_chain = len(chain_ids)
            L, N = self.seq_cand_aa_mat.shape[1:]

            chain_cand_score = np.zeros((n_chain, L, N))
            for i, chain_id in enumerate(chain_ids):
                chain = entry.chains[chain_id]
                chain.high_conf = chain.result.copy()
                free = np.array([c for c in range(N) if c not in self.used_cands])
                if len(free):
                    chain_cand_score[i][:, free] = self.seq_cand_aa_mat[fasta_ix][:, free]
            for i, chain_id in enumerate(chain_ids):
                for p, cand in enumerate(entry.chains[chain_id].result):
                    if cand != -1:
                        chain_cand_score[i, p, :] = 0
                        chain_cand_score[:, :, cand] = 0
                        chain_cand_score[i, p, cand] = 1

            mat = propagate_scores(chain_cand_score, self.n_hop_mat)
            for c in self.used_cands:
                mat[:, :, c] = 0
            entry.chain_cand_mat = mat

            # find gaps
            gaps = []
            for i, chain_id in enumerate(chain_ids):
                result = entry.chains[chain_id].result
                start = None
                for t, cand in enumerate(result):
                    if cand == -1:
                        if start is None:
                            start = t - 1
                    elif start is not None:
                        gaps.append((i, set(range(start + 1, t)), start, t))
                        start = None
                if start is not None:
                    gaps.append((i, set(range(start + 1, len(result))), start, len(result)))

            overlap = [
                sum(len(g[1] & h[1]) for h in gaps) for g in gaps
            ]
            for ix in np.argsort(overlap):
                g = gaps[ix]
                logger.info("filling gap chain=%s %d->%d", chain_ids[g[0]], g[2], g[3])
                self._fill_gap(fasta_ix, g)

        self._resolve_conflicts()

    # ------------------------------------------------------------------
    def _fill_gap(self, fasta_ix: int, gap) -> None:
        entry = self.entries[fasta_ix]
        chain_ids = list(entry.chains.keys())
        chain_ix, _, left_pos, right_pos = gap
        chain = entry.chains[chain_ids[chain_ix]]
        seq_len = len(entry)
        final_seq = list(range(left_pos, right_pos + 1))

        left_val = right_val = True
        direction = 1
        if left_pos == -1 and right_pos == seq_len:
            return
        if left_pos == -1:
            left_traces, left_infos, left_seq = [], [], []
            right_traces = [[int(chain.result[right_pos])]]
            right_infos = [[[], [], 0.0]]
            right_seq = [right_pos]
            left_val = False
            direction = -1
        elif right_pos == seq_len:
            left_traces = [[int(chain.result[left_pos])]]
            left_infos = [[[], [], 0.0]]
            left_seq = [left_pos]
            right_traces, right_infos, right_seq = [], [], []
            right_val = False
        else:
            left_traces = [[int(chain.result[left_pos])]]
            right_traces = [[int(chain.result[right_pos])]]
            left_infos = [[[], [], 0.0]]
            right_infos = [[[], [], 0.0]]
            left_seq = [left_pos]
            right_seq = [right_pos]

        mat = entry.chain_cand_mat

        while (left_val or right_val) and left_pos != right_pos \
                and left_pos < seq_len - 1 and right_pos > 0:
            if direction == 1:
                this_traces, this_infos = left_traces, left_infos
                left_pos += 1
                end = -1
                this_seq = left_seq + [left_pos]
                this_pos = left_pos
            else:
                this_traces, this_infos = right_traces, right_infos
                right_pos -= 1
                end = 0
                this_seq = [right_pos] + right_seq
                this_pos = right_pos

            # reference structure for the symmetry penalty
            matched_pos, matched_coords = [], []
            if self.protocol == "AF3_struct" and entry.af3_coords is not None:
                matched_pos = list(range(len(this_seq)))
                matched_coords = entry.af3_coords[this_seq]
            else:
                best_len = 5
                for other_id in chain_ids:
                    mp, mc = [], []
                    other = entry.chains[other_id].result
                    for p, pos in enumerate(this_seq):
                        if other[pos] != -1:
                            mp.append(p)
                            mc.append(self.cands.coords[other[pos]])
                    if len(mp) > best_len:
                        matched_pos, matched_coords = mp, np.asarray(mc)
                        best_len = len(mp)

            nt, ni, nsc = [], [], []
            for ix, trace in enumerate(this_traces):
                if len(trace) - len(set(trace)) > max(5, len(trace) // 10):
                    continue
                info = this_infos[ix]
                cand = trace[-1] if direction == 1 else trace[0]
                nei_list = (
                    set(self.cands.neighbors2to6[cand]) - self.used_cands - set(trace)
                )
                for nb in nei_list:
                    new_trace = trace + [nb] if direction == 1 else [nb] + trace
                    cand_score = info[0] + [mat[chain_ix, this_pos, nb]]
                    neigh_score = info[1] + [self.cands.neigh_mat[cand, nb]]
                    sym = info[2]
                    if len(this_seq) > 3 and len(this_seq) - 1 in matched_pos:
                        coords = self.cands.coords[[new_trace[p] for p in matched_pos]]
                        sym = max(0.0, superpose(coords, matched_coords)[0] - 1) / 2
                    score = float(
                        np.mean(np.asarray(cand_score) + np.asarray(neigh_score)) - sym
                    )
                    nt.append(new_trace)
                    ni.append([cand_score, neigh_score, sym])
                    nsc.append(score)

            if not nt:
                if direction == 1:
                    left_val = False
                else:
                    right_val = False
                direction *= -1
                continue
            elif len(nt) > BEAM_LIMIT or right_pos - left_pos <= 2:
                this_traces, this_infos = [], []
                last: Dict[int, list] = {}
                max_score, max_last = -np.inf, None
                for ix, trace in enumerate(nt):
                    key = trace[end]
                    if key not in last or nsc[ix] > last[key][1]:
                        last[key] = [trace, nsc[ix], ni[ix]]
                        if nsc[ix] > max_score:
                            max_score, max_last = nsc[ix], key
                for key, (trace, _, info) in last.items():
                    if self.cands.dist[key, max_last] < 20:
                        this_traces.append(trace)
                        this_infos.append(info)
                if direction == 1:
                    left_seq = left_seq + [left_pos]
                else:
                    right_seq = [right_pos] + right_seq
            else:
                if direction == 1:
                    left_seq = left_seq + [left_pos]
                else:
                    right_seq = [right_pos] + right_seq
                this_traces, this_infos = nt, ni

            if direction == 1:
                left_traces, left_infos = this_traces, this_infos
            else:
                right_traces, right_infos = this_traces, this_infos
            if left_val and right_val:
                direction *= -1

        def info_score(info):
            if not info[0]:
                return -np.inf
            return float(np.mean(np.asarray(info[0]) + np.asarray(info[1])) - info[2])

        max_trace = None
        max_score = -np.inf
        if left_traces and right_traces and \
                len(left_traces[0]) + len(right_traces[0]) - 1 == len(final_seq):
            for il, lt in enumerate(left_traces):
                for ir, rt in enumerate(right_traces):
                    if lt[-1] == rt[0]:
                        s = info_score(left_infos[il]) + info_score(right_infos[ir])
                        if s > max_score:
                            max_trace, max_score = lt + rt[1:], s
            if max_trace is not None:
                seen = set()
                for p in range(len(final_seq) // 2 + 1):
                    lp, rp = final_seq[p], final_seq[-p - 1]
                    if max_trace[p] not in seen:
                        seen.add(max_trace[p])
                        chain.result[lp] = max_trace[p]
                    if max_trace[-p - 1] not in seen:
                        seen.add(max_trace[-p - 1])
                        chain.result[rp] = max_trace[-p - 1]

        if max_trace is None:
            best_left = max(
                range(len(left_traces)), key=lambda i: info_score(left_infos[i]),
                default=None,
            ) if left_traces else None
            best_right = max(
                range(len(right_traces)), key=lambda i: info_score(right_infos[i]),
                default=None,
            ) if right_traces else None

            gap_cut = 0
            if best_left is not None and best_right is not None:
                lt, rt = left_traces[best_left], right_traces[best_right]
                gap_cut = max(
                    0.0,
                    self.cands.dist[lt[-1], rt[0]] - 3 * (right_pos - left_pos),
                ) // 6
            if best_left is not None:
                lt = left_traces[best_left]
                for p in range(len(left_seq) - int(gap_cut)):
                    chain.result[left_seq[p]] = lt[p]
            if best_right is not None:
                rt = right_traces[best_right]
                for p in range(int(gap_cut), len(right_seq)):
                    chain.result[right_seq[p]] = rt[p]

    # ------------------------------------------------------------------
    def _resolve_conflicts(self) -> None:
        """Drop duplicate candidate assignments far from their chain centroid
        (modeler.py:1850-1883)."""
        cand_occ: Dict[int, list] = {}
        centroids = {}
        for entry in self.entries:
            for chain_id, chain in entry.chains.items():
                hc = chain.high_conf
                coords = [self.cands.coords[c] for c in hc if c != -1]
                if coords:
                    centroids[(entry.name, chain_id)] = np.mean(coords, axis=0)
                for seq_id, cand in enumerate(chain.result):
                    if cand != -1:
                        cand_occ.setdefault(int(cand), []).append(
                            (entry.name, chain_id, seq_id)
                        )

        by_name = {e.name: e for e in self.entries}
        for cand, occs in cand_occ.items():
            dists = []
            for name, chain_id, _ in occs:
                cen = centroids.get((name, chain_id))
                d = np.inf if cen is None else float(
                    np.sum((cen - self.cands.coords[cand]) ** 2)
                )
                dists.append(d)
            min_d = min(dists)
            for (name, chain_id, seq_id), d in zip(occs, dists):
                if d > min_d + 1:
                    entry = by_name[name]
                    chain = entry.chains[chain_id]
                    for s in range(max(0, seq_id - 2), min(len(entry), seq_id + 3)):
                        if chain.high_conf[s] != -1:
                            continue
                        chain.result[s] = -1
