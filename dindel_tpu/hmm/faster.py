"""Sparse pair-HMM observation model — the reference's ``--faster`` path.

Behavioral port of ``ObservationModelS`` (Faster.{hpp:41-98,cpp:42-785})
plus the k-mer haplotype hash ``HapHash`` (Haplotype.hpp:315-384) and the
driver loop ``DetInDel::computeLikelihoodsFaster`` (DInDel.cpp:1793-1833).

Instead of the full (hap-position x ins-flag) state space, candidate
*relative placements* of the read on the haplotype are proposed from
k-mer (k=4) hash hits (top 15 by vote count, AlignHash,
Faster.cpp:129-188) and a small Viterbi runs over those sparse "relPos"
states plus per-state insertion flags (SStateHMM, Faster.cpp:254-577).

Reference quirks preserved deliberately (load-bearing for output parity):
  - ``hp>=0 || hp<hlen`` (Faster.cpp:491,529) is a tautology, so
    ``offHap``/``offHapHMQ`` are always False in this mode — every read
    counts as on-haplotype (onHap flag, DInDel.cpp:1822).
  - the MAP state at bMid is taken from the *HMQ*-prior fold
    (Faster.cpp:539).
  - right-overhang bases map to state ``hlen`` (the last haplotype base,
    Faster.cpp:565) rather than a distinct RO state, so reportVariants
    treats them as on-haplotype matches/SNPs at the last base and
    ``hpos`` never contains an RO code.
  - no positive-log-likelihood or NaN guards in the driver loop
    (contrast computeLikelihoods, DInDel.cpp:1722-1735).

This path exists for behavioral completeness; the dense batched device
kernels (hmm/batch.py) outperform it, so ``--faster`` trades
fidelity-to-reference for nothing except matching reference outputs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Set, Tuple

import numpy as np

from ..config import ObservationModelParameters
from ..model import (HPOS_INS, HPOS_LO, HPOS_RO, Haplotype, MLAlignment,
                     Read)
from ..variants import AlignedVariant

_EPS = 1e-7  # SStateHMM's update guard (Faster.cpp:260)
_MAXRELPOS = 15  # top hash placements tried (Faster.cpp:170)


def _map_char(c: str) -> int:
    # HapHash::map_char (Haplotype.hpp:367-371): non-ACGT -> 0
    return {"A": 0, "C": 1, "G": 2, "T": 3}.get(c, 0)


class HapHash:
    """k-mer hash of haplotype positions (Haplotype.hpp:315-384)."""

    def __init__(self, kmer: int, hap: Haplotype):
        self.kmer = kmer
        self.mask = (1 << (2 * kmer)) - 1
        self.hash: Dict[int, Set[int]] = {}
        seq = hap.seq
        # makeHash (Haplotype.hpp:374-377): x in [0, size()-kmer)
        for x in range(0, len(seq) - kmer):
            self.hash.setdefault(self.convert(seq, x), set()).add(x)

    def convert(self, seq: str, pos: int) -> int:
        if pos + self.kmer > len(seq):
            raise ValueError("HapHash string too short")
        v = 0
        for y in range(self.kmer):
            v |= _map_char(seq[pos + y]) << (2 * y)
        return v

    def push_back(self, key: int, c: str) -> int:
        return (key >> 2) | (_map_char(c) << (2 * (self.kmer - 1)))

    def lookup(self, key: int) -> Set[int]:
        return self.hash.get(key, set())


def _align_hash(hash_: HapHash, read: Read) -> List[int]:
    """AlignHash (Faster.cpp:129-188): vote relative placements from
    k-mer hits; return the top 15 by (count desc, relPos asc)."""
    kmer = hash_.kmer
    hpos_freq: Dict[int, int] = {}
    xl = read.size() - kmer
    key = hash_.convert(read.seq, 0)
    for x in range(0, xl + 1):
        for hp in hash_.lookup(key):
            rpfb = hp - x
            hpos_freq[rpfb] = hpos_freq.get(rpfb, 0) + 1
        if x != xl:
            key = hash_.push_back(key, read.seq[x + kmer])
    freq_to_pos: Dict[int, List[int]] = {}
    for rp, f in hpos_freq.items():
        freq_to_pos.setdefault(f, []).append(rp)
    rel_pos: List[int] = []
    for f in sorted(freq_to_pos, reverse=True):
        for rp in sorted(freq_to_pos[f]):
            if len(rel_pos) < _MAXRELPOS:
                rel_pos.append(rp)
            else:
                return rel_pos
    return rel_pos


class SparsePairHMM:
    """ObservationModelS (Faster.cpp:42-785)."""

    def __init__(self, hap: Haplotype, read: Read, hap_start: int,
                 params: ObservationModelParameters):
        if params.max_length_indel > hap.size():
            raise ValueError("hapSize error.")
        self.hap = hap
        self.read = read
        self.hap_start = hap_start
        self.params = params
        self.hlen = hap.size()
        self.rlen = read.size()
        self._compute_b_mid()
        self._setup_read_likelihoods()

    # ObservationModelS::computeBMid (Faster.cpp:60-88)
    def _compute_b_mid(self):
        read, hap = self.read, self.hap
        hap_start = self.hap_start
        hap_end = hap_start + hap.size()
        m_read_start = int(read.pos_stat_first)
        read_end = m_read_start + read.size() - 1
        if m_read_start > hap_end:
            b_mid = 0
        elif read_end < hap_start:
            b_mid = read.size() - 1
        else:
            ol_start = max(hap_start, m_read_start)
            ol_end = read_end if hap_end > read_end else hap_end
            b_mid = (ol_end - ol_start) // 2 + ol_start - m_read_start
        self.b_mid = min(max(b_mid, 0), read.size() - 1)

    # ObservationModelS::setupReadLikelihoods (Faster.cpp:91-128)
    def _setup_read_likelihoods(self):
        p = self.params
        read = self.read
        if p.model_type != "probabilistic":
            raise ValueError("Model not implemented.")
        pr = np.asarray(read.qual, np.float64) * (1.0 - p.p_mut)
        self.log_match = np.log(0.25 + 0.75 * pr)
        self.log_mismatch = np.log(0.75 + 1e-10 - 0.75 * pr)
        ll_match = float(self.log_match.sum())
        mq = 1.0 - read.map_qual
        if -10.0 * math.log10(mq) > p.cap_map_qual_fast:
            mq = 10.0 ** (-p.cap_map_qual_fast / 10.0)
        self.p_off_first = mq
        self.p_off_first_hmq = 1e-10
        logpe = math.log(1.0 - p.p_error)
        self.ll_off = math.log(mq) + ll_match + self.rlen * logpe
        self.ll_off_hmq = (math.log(self.p_off_first_hmq) + ll_match
                           + self.rlen * logpe)

    def align(self, hash_: HapHash) -> MLAlignment:
        """ObservationModelS::align (Faster.cpp:190-196)."""
        rel_pos = _align_hash(hash_, self.read)
        self.ml = MLAlignment()
        self._sstate_hmm(rel_pos)
        self._report_variants()
        return self.ml

    # SStateHMM (Faster.cpp:254-577)
    def _sstate_hmm(self, rel_pos: List[int]):
        p = self.params
        hlen, rlen, b_mid = self.hlen, self.rlen, self.b_mid
        read_len = rlen
        hap_seq = self.hap.seq
        read_seq = self.read.seq
        rel_pos = sorted(rel_pos + [-read_len])
        S = len(rel_pos)
        T = 2 * S
        tr = np.full((S, S), -1000.0)
        trI = np.full((S, S), -1000.0)
        alpha = np.full((read_len, T), -1000.0)
        bt = np.zeros((read_len, T), np.int32)
        obs = np.zeros((read_len, S))
        lm = self.log_match
        lmm = self.log_mismatch

        # per-base observation potentials (Faster.cpp:289-302)
        for r in range(read_len):
            for s in range(S):
                hp = rel_pos[s] + r
                if 0 <= hp < hlen:
                    obs[r, s] = (lm[r] if read_seq[r] == hap_seq[hp]
                                 else lmm[r])
                else:
                    obs[r, s] = lm[r]

        # bMid prior (Faster.cpp:330-345)
        prior = np.full(T, -1000.0)
        prior_hmq = np.full(T, -1000.0)
        for ins in range(2):
            pins = (math.log(1.0 - p.p_error) if ins == 0
                    else math.log(p.p_error))
            for y in range(S):
                x = y + ins * S
                hp = rel_pos[y] + b_mid
                if 0 <= hp < hlen:
                    prior[x] = math.log(1.0 - self.p_off_first) + pins
                    prior_hmq[x] = (math.log(1.0 - self.p_off_first_hmq)
                                    + pins)
                else:
                    prior[x] = math.log(self.p_off_first) + pins
                    prior_hmq[x] = math.log(self.p_off_first_hmq) + pins

        logp_ins_g_noins = math.log(p.p_error)
        logp_ins_g_ins = -0.25
        logp_noins_g_ins = math.log(1 - math.exp(logp_ins_g_ins))

        # transitions between relPos (Faster.cpp:352-365)
        for s1 in range(S):
            for s2 in range(S):
                if s1 != s2:
                    d = abs(rel_pos[s1] - rel_pos[s2])
                    tr[s1, s2] = ((d - 1.0) * logp_ins_g_ins
                                  + math.log(p.p_error))
                    trI[s1, s2] = (d - 1.0) * logp_ins_g_ins
                else:
                    tr[s1, s2] = math.log(1.0 - p.p_error)

        def upd(r, ns, nv, src):
            if nv > alpha[r, ns] + _EPS:
                alpha[r, ns] = nv
                bt[r, ns] = src

        # left -> bMid (Faster.cpp:372-414)
        for r in range(0, b_mid):
            for cs in range(S):
                pv = obs[r, cs] + (alpha[r - 1, cs] if r else 0.0)
                for ns in range(cs, S):
                    upd(r, ns, pv + tr[cs, ns], cs)
                upd(r, cs + S, pv + logp_noins_g_ins, cs)
                ics = cs + S
                nv = lm[r] + logp_ins_g_ins + (alpha[r - 1, ics] if r
                                               else 0.0)
                upd(r, ics, nv, ics)
                base = lm[r] + (alpha[r - 1, ics] if r else 0.0)
                for ns in range(0, cs):
                    if rel_pos[cs] - r >= rel_pos[ns]:
                        upd(r, ns, base + trI[cs, ns] + logp_ins_g_noins,
                            ics)

        # right -> bMid (Faster.cpp:420-462)
        for r in range(read_len - 1, b_mid, -1):
            for cs in range(S):
                pv = obs[r, cs] + (alpha[r + 1, cs] if r < read_len - 1
                                   else 0.0)
                for ns in range(0, cs + 1):
                    upd(r, ns, pv + tr[cs, ns], cs)
                nv = lm[r] + logp_ins_g_noins + (
                    alpha[r + 1, cs + S] if r < read_len - 1 else 0.0)
                upd(r, cs, nv, cs + S)
                ics = cs + S
                nv = lm[r] + logp_ins_g_ins + (
                    alpha[r + 1, ics] if r < read_len - 1 else 0.0)
                upd(r, ics, nv, ics)
                base = obs[r, cs] + logp_noins_g_ins + (
                    alpha[r + 1, cs] if r < read_len - 1 else 0.0)
                for ns in range(cs + 1, S):
                    if rel_pos[cs] > rel_pos[ns] - r:
                        upd(r, ns + S, base + trI[cs, ns], cs)

        # combine at bMid with the true-mapQual prior -> ml.ll
        # (Faster.cpp:466-506)
        best = -math.inf
        for ins in range(2):
            for y in range(S):
                x = ins * S + y
                obsv = obs[b_mid, y] if ins == 0 else lm[b_mid]
                v = obsv + prior[x]
                if b_mid < read_len - 1:
                    v += alpha[b_mid + 1, x]
                if b_mid > 0:
                    v += alpha[b_mid - 1, x]
                alpha[b_mid, x] = v
                if v > best:
                    best = v
        # `hp>=0 || hp<hlen` (Faster.cpp:491) is always true: never off-hap
        self.ml.off_hap = False
        self.ml.ll = best

        # HMQ fold; its argmax seeds the MAP backtrack (Faster.cpp:507-539)
        best = -math.inf
        xmax = 0
        for ins in range(2):
            for y in range(S):
                x = ins * S + y
                obsv = obs[b_mid, y] if ins == 0 else lm[b_mid]
                v = obsv + prior_hmq[x]
                if b_mid < read_len - 1:
                    v += alpha[b_mid + 1, x]
                if b_mid > 0:
                    v += alpha[b_mid - 1, x]
                if v > best:
                    best = v
                    xmax = x
        self.ml.off_hap_hmq = False  # same tautology (Faster.cpp:528)

        state = np.full(read_len, -1, np.int32)
        state[b_mid] = xmax
        for b in range(b_mid, 0, -1):
            state[b - 1] = bt[b - 1, state[b]]
        for b in range(b_mid, read_len - 1):
            state[b + 1] = bt[b + 1, state[b]]

        # relPos -> absolute positions, LO/x/"RO"=hlen codes
        # (Faster.cpp:554-573)
        map_state = np.zeros(read_len, np.int32)
        lhp = 1
        for r in range(read_len):
            if state[r] < S:
                hp = rel_pos[state[r]] + r
                if 0 <= hp < hlen:
                    map_state[r] = hp + 1
                    lhp = hp + 1
                elif hp < 0:
                    map_state[r] = 0
                else:
                    map_state[r] = hlen  # reference maps RO to hlen
            else:
                map_state[r] = hlen + 2 + lhp
        self.map_state = map_state

    # ObservationModelS::reportVariants (Faster.cpp:579-675)
    def _report_variants(self):
        hap, read, ml = self.hap, self.read, self.ml
        hap_size, read_size = self.hlen, self.rlen
        num_s = hap_size + 2
        ms = self.map_state
        ml.align = list("R" * hap_size)
        ml.indels = {}
        ml.snps = {}
        ml.first_base = -1
        ml.last_base = -1
        ml.hap_indel_covered = {}
        ml.hap_snp_covered = {}
        ml.hpos = [0] * read_size
        b = 0
        while b < read_size:
            s = int(ms[b])
            sm = s % num_s
            if 0 < sm <= hap_size:
                if s >= num_s:  # insertion before base sm
                    pos = sm - 1 + 1
                    ln = 0
                    rpos = b
                    while b < read_size and ms[b] >= num_s:
                        ml.hpos[b] = HPOS_INS
                        b += 1
                        ln += 1
                    seq = read.seq[rpos:rpos + ln]
                    ml.indels[pos] = AlignedVariant(
                        "+" + seq, pos, pos, rpos, b - 1)
                    b -= 1
                else:
                    ml.hpos[b] = s - 1
                    if ml.first_base == -1 or s - 1 < ml.first_base:
                        ml.first_base = s - 1
                    if ml.last_base == -1 or s - 1 > ml.last_base:
                        ml.last_base = s - 1
                    if read.seq[b] != hap.seq[s - 1]:
                        snp = hap.seq[s - 1] + "=>" + read.seq[b]
                        ml.snps[s - 1] = AlignedVariant(snp, s - 1, s - 1,
                                                        b, b)
                        ml.align[s - 1] = read.seq[b]
                    if b < read_size - 1:
                        ns = int(ms[b + 1])
                        if ns < num_s and ns - s > 1:
                            pos = s
                            ln = ns - s - 1
                            for y in range(pos, pos + ln):
                                ml.align[y] = "D"
                            seq = hap.seq[pos:pos + ln]
                            ml.indels[pos] = AlignedVariant(
                                "-" + seq, pos, pos + ln - 1, b, b + 1)
            else:
                ml.hpos[b] = HPOS_LO if sm == 0 else HPOS_RO
            b += 1
        ml.align = "".join(ml.align)
        for pos, av in hap.indels.items():
            ml.hap_indel_covered[pos] = av.is_covered(
                self.params.pad_cover, ml.first_base, ml.last_base)
        for pos, av in hap.snps.items():
            ml.hap_snp_covered[pos] = av.is_covered(
                self.params.pad_cover, ml.first_base, ml.last_base)


def compute_likelihoods_faster(haps: List[Haplotype], reads: List[Read],
                               left_pos: int,
                               params: ObservationModelParameters
                               ) -> Tuple[List[List[MLAlignment]],
                                          List[int]]:
    """DetInDel::computeLikelihoodsFaster (DInDel.cpp:1793-1833).

    (The reference also calls computeHapPosition per pair there but never
    uses its result — dead code, not ported.)  Unlike computeLikelihoods
    there are no positive-ll / NaN guards."""
    kmer = 4
    liks: List[List[MLAlignment]] = []
    on_hap = [0] * len(reads)
    for hap in haps:
        hash_ = HapHash(kmer, hap)
        row = []
        for ri, read in enumerate(reads):
            om = SparsePairHMM(hap, read, left_pos, params)
            ml = om.align(hash_)
            row.append(ml)
            if not ml.off_hap_hmq:
                on_hap[ri] = 1
        liks.append(row)
    return liks, on_hap
