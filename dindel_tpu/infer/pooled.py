"""Pooled / haplotype-frequency caller: variational-Bayes EM with a
Dirichlet prior, a port of DetInDel::estimateHaplotypeFrequenciesBayesEM
(DInDel.cpp:2103-2930) plus the simple ML-EM
(estimateHaplotypeFrequencies, DInDel.cpp:3665-3762).

The EM loops run per active-variant set on the (reads x haps) log-lik
matrix in float64; digamma is evaluated on host (math.lgamma-free series,
matching boost::math::digamma to ~1e-15)."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Set, Tuple

from ..config import Parameters
from ..model import Haplotype, MLAlignment, Read
from ..out.glf import OutputData
from ..utils import add_logs
from ..variants import AlignedCandidates, AlignedVariant, DEL, INS, SNP

NEG = -math.inf


def digamma(x: float) -> float:
    """Psi function; asymptotic series after upward recurrence (agrees with
    boost::math::digamma used at DInDel.cpp:2466,2472 to ~1e-15)."""
    r = 0.0
    while x < 6.0:
        r -= 1.0 / x
        x += 1.0
    f = 1.0 / (x * x)
    return (r + math.log(x) - 0.5 / x
            - f * (1.0 / 12.0
                   - f * (1.0 / 120.0
                          - f * (1.0 / 252.0
                                 - f * (1.0 / 240.0
                                        - f * (1.0 / 132.0
                                               - f * 691.0 / 32760.0))))))


def _is_real_variant(av: AlignedVariant) -> bool:
    return not av.is_ref and not (av.is_snp and len(av.str) > 3 and av.str[3] == "D")


def _var_log_prior(av_list, candidates: AlignedCandidates, left_pos: int,
                   params: Parameters) -> float:
    lp = 0.0
    for avar in av_list:
        lnf = 0.0
        if avar.type == SNP:
            lnf = math.log(params.prior_snp)
        elif avar.type in (DEL, INS):
            lnf = math.log(params.prior_indel)
        av = candidates.find_variant(avar.start_hap + left_pos, avar.type, avar.str)
        if av is None:
            lp += lnf
        else:
            lp += lnf if av.freq < 0.0 else math.log(av.freq)
    return lp



def _collect_variants(haps):
    """Distinct real variants over the hap set, in (pos, str) order
    (DInDel.cpp:2145-2174)."""
    all_variants: List[Tuple[int, AlignedVariant]] = []
    seen: Set[Tuple[int, str]] = set()
    for hap in haps:
        for p, av in hap.indels.items():
            if _is_real_variant(av) and (p, av.str) not in seen:
                seen.add((p, av.str))
                all_variants.append((p, av))
    all_variants.sort(key=lambda pa: (pa[0], pa[1].str))
    all_by_pos: Dict[int, List[Tuple[int, AlignedVariant]]] = {}
    for p, av in all_variants:
        all_by_pos.setdefault(p, []).append((p, av))
    return all_variants, all_by_pos


def _build_active_sets(haps, filtered, program, all_variants, all_by_pos):
    """Active-variant sets per program (DInDel.cpp:2176-2289)."""
    active_sets: List[Set[Tuple[int, str]]] = []
    active_snps: List[List[AlignedVariant]] = []
    active_indels: List[List[AlignedVariant]] = []
    av_by_key = {(p, av.str): av for p, av in all_variants}
    nh = len(haps)

    def split_set(s: Set[Tuple[int, str]]):
        snps = sorted(k for k in s if av_by_key[k].is_snp)
        indels = sorted(k for k in s if av_by_key[k].is_indel)
        return [av_by_key[k] for k in snps], [av_by_key[k] for k in indels]

    if program == "all":
        s = set(av_by_key)
        active_sets.append(s)
        sn, ind = split_set(s)
        active_snps.append(sn)
        active_indels.append(ind)
    elif program == "singlevariant":
        ss: List[Set[Tuple[int, str]]] = []
        seen_sets: Set[frozenset] = set()
        for h in range(nh):
            if filtered[h]:
                continue
            act = {(p, av.str) for p, av in haps[h].indels.items()
                   if _is_real_variant(av)}
            fz = frozenset(act)
            if fz not in seen_sets:
                seen_sets.add(fz)
                ss.append(act)
        # std::set<std::set<PAV>> iterates in sorted order
        ss.sort(key=lambda s: sorted(s))
        for s in ss:
            active_sets.append(s)
            sn, ind = split_set(s)
            active_snps.append(sn)
            active_indels.append(ind)
    elif program == "priorpersite":
        active_sets.append(set())
        active_snps.append([])
        active_indels.append([])
        for p in sorted(all_by_pos):
            site = {(pp, av.str) for pp, av in all_by_pos[p]}
            prev_n = len(active_sets)
            for pna in range(prev_n):
                s = set(active_sets[pna]) | site
                active_sets.append(s)
                sn, ind = split_set(s)
                active_snps.append(sn)
                active_indels.append(ind)
    else:
        raise ValueError("Unknown EM option")
    return active_sets, active_snps, active_indels


def _compat_for(haps, filtered, active_set):
    """Haplotype-compatibility mask for one active set
    (DInDel.cpp:2407-2429)."""
    nh = len(haps)
    compatible = [1] * nh
    numah = 0
    for h in range(nh):
        if filtered[h]:
            compatible[h] = 0
        else:
            for p, av in haps[h].indels.items():
                if _is_real_variant(av) and (p, av.str) not in active_set:
                    compatible[h] = 0
                    break
        if compatible[h]:
            numah += 1
    return compatible, numah


def em_inputs(haps, reads, liks, params, filtered, program):
    """Per-window inputs for the batched device EM
    (infer/device_em.run_batched_em): (rlT (nr, nh) float array,
    compat (nav, nh) bool, numah (nav,)).  Same active-set enumeration
    as estimate_hap_freqs_bayes_em, so device results align 1:1 with
    its th loop."""
    import numpy as np

    from .arrays import LiksArrays

    A = LiksArrays(liks, haps, reads, params)
    rlT = A.ll.T
    all_variants, all_by_pos = _collect_variants(haps)
    active_sets, _sn, _ind = _build_active_sets(
        haps, filtered, program, all_variants, all_by_pos)
    nav = len(active_sets)
    nh = len(haps)
    compat = np.zeros((nav, nh), bool)
    numah = np.zeros(nav, np.float64)
    for a in range(nav):
        c, na = _compat_for(haps, filtered, active_sets[a])
        compat[a] = np.array(c, bool)
        numah[a] = na
    return rlT, compat, numah


def estimate_hap_freqs_bayes_em(
        haps: List[Haplotype], reads: List[Read],
        liks: List[List[MLAlignment]], cand_pos: int, left_pos: int,
        right_pos: int, glf_data: Optional[OutputData], index: int,
        candidates: AlignedCandidates, params: Parameters,
        filtered: List[int],
        var_coverage: Dict[Tuple[int, str], Tuple[int, int]],
        num_bams: int, program: str = "all", em_results=None):
    """Returns (hap_freqs, posteriors, rows). posteriors: list of
    (variant, pos, prob, freq, nf, nr) — HapEstResult mirror.

    em_results: optional device-EM output (infer/device_em) — a list of
    (loglik, pi) per active set in th order; when given, the host EM
    while-loop is skipped (f32 device production path; the host loop stays
    the byte-parity anchor)."""
    import numpy as np
    from .arrays import LiksArrays, add_logs_arr, seq_sum

    nh = len(haps)
    nr = len(reads)
    rows: List[dict] = []

    A = LiksArrays(liks, haps, reads, params)
    rlT = A.ll.T  # (nr, nh): the reference's rl[r*nh+h]

    off_all_v = A.off.all(axis=0)
    unmapped_v = np.array([r.is_unmapped for r in reads], bool)
    num_read_off_all = int(off_all_v.sum())
    num_unmapped_realigned = int((~off_all_v & unmapped_v).sum())

    # collect variants + active-variant sets (DInDel.cpp:2145-2289)
    all_variants, all_by_pos = _collect_variants(haps)
    nv = len(all_variants)
    active_sets, active_snps, active_indels = _build_active_sets(
        haps, filtered, program, all_variants, all_by_pos)
    nav = len(active_sets)

    active = [[0] * nv for _ in range(nav)]
    hap_has_var = [[0] * nv for _ in range(nh)]
    for idx, (p, av) in enumerate(all_variants):
        for a in range(nav):
            if (p, av.str) in active_sets[a]:
                active[a][idx] = 1
        for h in range(nh):
            it = haps[h].indels.get(p)
            if it is not None and it.str == av.str:
                hap_has_var[h][idx] = 1

    logz = NEG
    a0 = params.bayes_a0
    logliks = [0.0] * nav
    logpriors = [0.0] * nav
    freqs = [[0.0] * nh for _ in range(nav)]

    for th in range(nav):
        logprior = _var_log_prior(active_snps[th], candidates, left_pos, params)
        logprior += _var_log_prior(active_indels[th], candidates, left_pos, params)
        logpriors[th] = logprior

        compatible, numah = _compat_for(haps, filtered, active_sets[th])

        if em_results is not None:
            # device EM (infer/device_em) already ran this set
            loglik, pi = em_results[th]
            pi = np.asarray(pi, np.float64)
            zsum = sum(math.exp(x) for x in pi)
            logliks[th] = loglik
            logz = add_logs(logz, logliks[th] + logprior)
            for h in range(nh):
                freqs[th][h] = math.exp(pi[h]) / zsum
            continue

        # VB-EM (DInDel.cpp:2411-2523), vectorized over (reads, haps) with
        # the reference's accumulation orders: lognorm folds over h in
        # index order, nk/loglik/e_new fold over r (then h) in index order
        lpi = np.array([math.log(1.0 / numah) if compatible[h] else -100.0
                        for h in range(nh)])
        pi = np.zeros(nh)
        e_old = NEG
        iter_ = 0
        loglik = 0.0
        compat_v = np.array(compatible, bool)
        while True:
            Z = lpi[None, :] + rlT            # (nr, nh)
            lognorm = np.full(nr, NEG)
            for h in range(nh):
                lognorm = add_logs_arr(lognorm, Z[:, h])
            zz = np.exp(Z - lognorm[:, None])
            nk = np.cumsum(zz, axis=0)[-1] if nr else np.zeros(nh)
            loglik = seq_sum(lognorm)
            ak = np.where(compat_v, nk + a0, 0.0)
            ahat = seq_sum(ak[compat_v])
            dahat = digamma(ahat)
            lpi = np.full(nh, -100.0)
            for h in range(nh):
                if compatible[h]:
                    lpi[h] = digamma(ak[h]) - dahat
            with np.errstate(divide="ignore"):
                pi = np.where(compat_v,
                              np.log((a0 + nk) / (numah * a0 + nr)), -100.0)
            e_new = seq_sum((zz * (pi[None, :] + rlT)).ravel())
            converged = abs(e_old - e_new) < params.em_tol or iter_ > 25
            e_old = e_new
            iter_ += 1
            if converged:
                break

        zsum = sum(math.exp(x) for x in pi)
        logliks[th] = loglik
        logz = add_logs(logz, logliks[th] + logprior)
        for h in range(nh):
            freqs[th][h] = math.exp(pi[h]) / zsum

    post = [math.exp(logliks[a] + logpriors[a] - logz) for a in range(nav)]
    hap_freqs = [0.0] * nh
    for th in range(nav):
        w = math.exp(logliks[th] + logpriors[th] - logz)
        for h in range(nh):
            hap_freqs[h] += w * freqs[th][h]

    # per-variant marginal posteriors + per-BAM GLF lines (DInDel.cpp:2578-2816)
    readidx: List[List[int]] = [[] for _ in range(num_bams)]
    for r in range(nr):
        readidx[reads[r].pool_id].append(r)

    reverse_v = np.array([r.on_reverse_strand for r in reads], bool)
    mq2_v = np.array([(-10.0 * math.log10(1.0 - r.map_qual)) ** 2
                      for r in reads])
    # all unordered hap pairs in loop order, and their per-read fold terms
    # log(0.5)+addLogs(rl[r][h1],rl[r][h2]) (shared by every variant/pool)
    pair_list = [(h1, h2) for h1 in range(nh) for h2 in range(h1, nh)]
    h1v = np.array([pq[0] for pq in pair_list])
    h2v = np.array([pq[1] for pq in pair_list])
    log5 = math.log(0.5)
    T_all = log5 + add_logs_arr(A.ll[h1v, :], A.ll[h2v, :])
    # per-read ML haplotypes within 1e-7 (DInDel.cpp:2690-2700)
    ml_mask = A.ll >= (A.ll.max(axis=0)[None, :] - 1e-7)

    posteriors = []
    for idx, (p, pav) in enumerate(all_variants):
        logp = NEG
        freq = 0.0
        for th in range(nav):
            if active[th][idx]:
                logp = add_logs(logp, logliks[th] + logpriors[th])
        for h in range(nh):
            if hap_has_var[h][idx]:
                freq += hap_freqs[h]
        logp -= logz

        av = candidates.find_variant(pav.start_hap + left_pos, pav.type, pav.str)
        do_glf = av is not None

        prior_pair = [[0.0] * nh for _ in range(nh)]
        if params.output_glf and do_glf:
            # marginalize frequencies over the presence of this variant
            marsum = [0] * nv
            s = 1
            for y in range(nv):
                if y != idx:
                    marsum[y] = s
                    s *= 2
            mar_states: Dict[int, int] = {}
            otn = {}
            for h in range(nh):
                nidx = sum(marsum[v] * hap_has_var[h][v] for v in range(nv))
                if nidx in mar_states:
                    otn[h] = mar_states[nidx]
                else:
                    ns = len(mar_states)
                    mar_states[nidx] = ns
                    otn[h] = ns
            nmarhap = len(mar_states)
            mar_freqs = [0.0] * nmarhap
            for h in range(nh):
                mar_freqs[otn[h]] += hap_freqs[h]
            for h in range(nmarhap):
                mar_freqs[h] = -50.0 if mar_freqs[h] < 1e-16 else math.log(mar_freqs[h])
            for h1 in range(nh):
                for h2 in range(h1, nh):
                    prior_pair[h1][h2] = mar_freqs[otn[h1]] + mar_freqs[otn[h2]]

        totnf = totnr = 0
        # reads whose ML haplotype covers this variant, by strand
        covm = np.zeros((nh, nr), bool)
        for h in range(nh):
            if hap_has_var[h][idx]:
                if pav.is_indel:
                    covm[h] = A.indel_covered(h, p)
                elif pav.is_snp:
                    covm[h] = A.snp_covered(h, p)
        hit_v = (ml_mask & covm).any(axis=0)
        for b in range(num_bams):
            msq = 0.0
            nf = nr_c = 0
            lik = [0.0, 0.0, 0.0]
            if readidx[b]:
                idxb = np.array(readidx[b])
                if params.output_glf and do_glf:
                    lik = [NEG, NEG, NEG]
                    # exact fold order: ll = prior_pair; ll += t_r over the
                    # pool's reads; then add_logs-merge by genotype in
                    # pair order (DInDel.cpp:2668-2689)
                    ppv = np.array([prior_pair[h1][h2]
                                    for h1, h2 in pair_list])
                    lls = np.cumsum(
                        np.concatenate([ppv[None, :], T_all[:, idxb].T],
                                       axis=0), axis=0)[-1]
                    for k, (h1, h2) in enumerate(pair_list):
                        genotype = hap_has_var[h1][idx] + hap_has_var[h2][idx]
                        lik[genotype] = add_logs(lik[genotype], float(lls[k]))
                n = len(readidx[b])
                nf = int((hit_v[idxb] & ~reverse_v[idxb]).sum())
                nr_c = int((hit_v[idxb] & reverse_v[idxb]).sum())
                msq = seq_sum(mq2_v[idxb])
                msq = math.sqrt(msq / n) if n != 0 else 0.0
                totnf += nf
                totnr += nr_c

            if params.output_glf and do_glf:
                row = dict(msg="ok", index=index, tid=params.tid,
                           analysis_type=program, indidx=b,
                           was_candidate_in_window=1, lpos=left_pos,
                           rpos=right_pos, center_position=cand_pos,
                           realigned_position=p + left_pos,
                           post_prob_variant=math.exp(logp), est_freq=freq,
                           logZ=logz, nref_all=pav.str,
                           num_reads=len(readidx[b]), msq=msq,
                           num_cover_forward=nf, num_cover_reverse=nr_c,
                           num_unmapped_realigned=num_unmapped_realigned,
                           var_coverage_forward=var_coverage.get((p, pav.str), (0, 0))[0],
                           var_coverage_reverse=var_coverage.get((p, pav.str), (0, 0))[1])
                if b == 0:
                    hf_parts = []
                    for h in range(nh):
                        if hap_freqs[h] > 1.0 / (2 * nr):
                            vars_str = []
                            for pp, avv in sorted(haps[h].indels.items()):
                                if avv.str != "*REF":
                                    vars_str.append(f"{left_pos + pp},{avv.str}")
                            body = ",".join(vars_str) if vars_str else "REF"
                            hf_parts.append(f"{body}:{_g(hap_freqs[h])}")
                    row["hapfreqs"] = ";".join(hf_parts)
                likstring = ";".join(
                    f"{gt}:{_g(lik[i])}" for i, gt in enumerate(("0/0", "0/1", "1/1")))
                row["glf"] = likstring
                rows.append(row)
                _emit(glf_data, row)
        posteriors.append((pav, p, math.exp(logp), freq, totnf, totnr))

    if params.output_pooled_likelihoods:
        from ..out.debug_dumps import write_pooled_dumps
        write_pooled_dumps(params.file_name, params.tid, cand_pos, haps,
                           reads, liks, hap_freqs,
                           [(p, av) for p, av in all_variants],
                           hap_has_var, left_pos)

    return hap_freqs, posteriors, rows


def estimate_hap_freqs_ml(haps: List[Haplotype], reads: List[Read],
                          liks: List[List[MLAlignment]],
                          params: Parameters) -> List[float]:
    """Plain maximum-likelihood EM over haplotype frequencies
    (DetInDel::estimateHaplotypeFrequencies, DInDel.cpp:3665-3762; unused
    by the reference's production paths but part of its API surface)."""
    nh = len(haps)
    nr = len(reads)
    pi = [math.log(1.0 / nh)] * nh
    e_old = NEG
    it = 0
    while True:
        nk = [0.0] * nh
        z = [[0.0] * nh for _ in range(nr)]
        for r in range(nr):
            lognorm = NEG
            for h in range(nh):
                z[r][h] = pi[h] + liks[h][r].ll
                lognorm = add_logs(lognorm, z[r][h])
            for h in range(nh):
                z[r][h] = math.exp(z[r][h] - lognorm)
                nk[h] += z[r][h]
        for h in range(nh):
            pi[h] = math.log(nk[h] / nr) if nk[h] > 0 else -745.0
        e_new = 0.0
        for r in range(nr):
            for h in range(nh):
                e_new += z[r][h] * (pi[h] + liks[h][r].ll)
        converged = abs(e_old - e_new) < params.em_tol or it > 25
        e_old = e_new
        it += 1
        if converged:
            break
    return [math.exp(x) for x in pi]


def _g(x: float) -> str:
    return "%g" % x


def _emit(glf_data: Optional[OutputData], row: dict) -> None:
    if glf_data is None:
        return
    line = glf_data.line()
    for k, v in row.items():
        line.set(k, v)
    glf_data.output(line)
