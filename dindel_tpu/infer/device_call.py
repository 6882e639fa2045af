"""Device-side Bayesian calling: the diploid pair-posterior and per-site
genotype folds (reference hot loops #3-#4, DInDel.cpp:3085-3113 and
:3310-3660) as on-device scans over the slab's log-likelihood tensor,
plus the host-side staging tables that feed them.

Split of labor (SURVEY.md §3.1 / §7):
  - at STAGING time (before the HMM dispatch) the engine builds, per
    window, everything derivable from haplotypes + candidates alone:
    the variant inventory, per-pair haplotype priors, per-(site, pair)
    pair priors, and the filter's variant flank tables
    (build_call_tables);
  - the DEVICE computes, per window, the read folds over those tables
    (_window_call): base_ll[k] = fold_r log(.5 e^l1 + .5 e^l2) and
    site_lls[s, k] = the same fold seeded at the per-site pair prior —
    sequential lax.scan in the reference's exact accumulation order, so
    under float64 the results are bit-identical to the host caller;
  - the HOST (diploid_glf_dev) keeps only the tiny order-dependent
    bookkeeping: MAP-pair selection, per-site genotype merging and GLF
    row assembly, consuming device scalars.

Bit-parity of the full GLF output between this path and the host anchor
caller (infer/diploid.py) is asserted in tests/test_device_call.py and
by the golden pipeline fixtures."""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import Parameters
from ..model import Haplotype, Read
from ..out.glf import OutputData
from ..utils import add_logs
from ..variants import (AlignedCandidates, AlignedVariant, DEL, INS, SNP)
from .diploid import (_WindowThrow, _emit, _g, _is_real_variant,
                      get_pair_prior)

NEG = -math.inf
VARSNP = 1
VARINDEL = 2


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pair_enum(nh: int) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's unordered-pair order: h1 outer, h2 >= h1 inner."""
    h1v = np.array([h1 for h1 in range(nh) for h2 in range(h1, nh)],
                   np.int32)
    h2v = np.array([h2 for h1 in range(nh) for h2 in range(h1, nh)],
                   np.int32)
    return h1v, h2v


def build_call_tables(haps: List[Haplotype], candidates: AlignedCandidates,
                      left_pos: int, params: Parameters) -> dict:
    """Per-window host tables for device calling (pure function of the
    generated haplotypes + the candidate list — no device results).

    Mirrors the variant inventory of diploid_glf (DInDel.cpp:2969-3017)
    and vectorizes the per-pair prior loops: find_variant runs once per
    distinct variant key instead of once per (pair, site)."""
    nh = len(haps)

    fv_cache: Dict[Tuple[int, int, str], object] = {}

    def find_variant(pos, type_, s):
        key = (pos, type_, s)
        if key not in fv_cache:
            fv_cache[key] = candidates.find_variant(pos, type_, s)
        return fv_cache[key]

    # --- variant inventory (identical construction to diploid_glf) ---
    all_variants: List[Tuple[int, AlignedVariant]] = []
    seen: Set[Tuple[int, str]] = set()
    hap_num_indels = [h.count_indels() for h in haps]
    hap_num_snps = [h.count_snps() for h in haps]
    hap_num_candidate_indels = [0] * nh
    for th, hap in enumerate(haps):
        if hap_num_indels[th] != 0:
            nc = 0
            for av in hap.indels.values():
                if find_variant(av.start_hap + left_pos, av.type, av.str):
                    nc += 1
            hap_num_candidate_indels[th] = nc
        for p, av in hap.indels.items():
            if _is_real_variant(av) and (p, av.str) not in seen:
                seen.add((p, av.str))
                all_variants.append((p, av))
    all_variants.sort(key=lambda pa: (pa[0], pa[1].str))
    all_by_pos: Dict[int, List[Tuple[int, AlignedVariant]]] = {}
    for p, av in all_variants:
        all_by_pos.setdefault(p, []).append((p, av))
    var_positions = sorted(all_by_pos)
    pos_to_idx = {p: i for i, p in enumerate(var_positions)}
    num_var_pos = len(var_positions)
    nv = len(all_variants)

    hap_var = np.zeros((nh, num_var_pos), np.int32)
    var_type = [0] * (nv + 1)
    variants: List[Optional[Tuple[int, AlignedVariant]]] = [None] * (nv + 1)
    for idx, (p, av) in enumerate(all_variants, start=1):
        var_type[idx] = VARINDEL if av.is_indel else VARSNP
        pi = pos_to_idx[p]
        for h in range(nh):
            it = haps[h].indels.get(p)
            if it is not None and it.str == av.str:
                hap_var[h, pi] = idx
        variants[idx] = (p, av)

    # --- per-pair haplotype priors (getHaplotypePrior,
    # DInDel.cpp:1857-1927), vectorized: the fold iterates the pair's
    # key union in sorted(indels)+sorted(snps) order; per-key values are
    # shared, so one cumsum over a membership mask replays it exactly
    # (masked terms add +0.0, an exact identity) ---
    ind_keys: Set[Tuple[int, str]] = set()
    snp_keys: Set[Tuple[int, str]] = set()
    av_of: Dict[Tuple[int, str], AlignedVariant] = {}
    memb: List[Tuple[Set, Set]] = []
    for h in haps:
        hi: Set[Tuple[int, str]] = set()
        hs: Set[Tuple[int, str]] = set()
        for av in h.indels.values():
            if "*REF" not in av.str and "=>" not in av.str:
                key = (av.start_hap, av.str)
                hi.add(key)
                av_of[key] = av
        for av in h.snps.values():
            if "*REF" not in av.str and "=>D" not in av.str:
                key = (av.start_hap, av.str)
                hs.add(key)
                av_of[key] = av
        ind_keys |= hi
        snp_keys |= hs
        memb.append((hi, hs))
    keys = sorted(ind_keys) + sorted(snp_keys)
    kval = np.zeros(len(keys))
    for i, key in enumerate(keys):
        avar = av_of[key]
        av = find_variant(avar.start_hap + left_pos, avar.type, avar.str)
        if av is None or av.freq < 0.0:
            kval[i] = math.log(params.prior_indel)
        else:
            kval[i] = math.log(av.freq)
    kmask = np.zeros((nh, len(keys)), bool)
    for h, (hi, hs) in enumerate(memb):
        for i, key in enumerate(keys):
            kmask[h, i] = key in hi or key in hs
    h1v, h2v = pair_enum(nh)
    npair = len(h1v)
    if keys:
        um = kmask[h1v] | kmask[h2v]
        prior_v = np.cumsum(np.where(um, kval[None, :], 0.0), axis=1)[:, -1]
    else:
        prior_v = np.zeros(npair)

    # --- per-(site, pair) pair priors (getPairPrior, DInDel.cpp:
    # 1835-1855), cached per distinct (v1, v2) allele combination ---
    ref_av = AlignedVariant("*REF", start_hap=-1)
    pp_cache: Dict[Tuple[int, int], float] = {}

    def pair_prior_pos(v1: int, v2: int) -> float:
        key = (v1, v2)
        if key not in pp_cache:
            av1 = variants[v1][1] if v1 else ref_av
            av2 = variants[v2][1] if v2 else ref_av
            pp_cache[key] = get_pair_prior(av1, av2, left_pos, candidates,
                                           params)
        return pp_cache[key]

    pair_pr = np.zeros((num_var_pos, npair))
    pair_geno = np.zeros((num_var_pos, npair, 2), np.int32)
    for si in range(num_var_pos):
        for k in range(npair):
            v1 = int(hap_var[h1v[k], si])
            v2 = int(hap_var[h2v[k], si])
            g = sorted({v1, v2})
            pair_geno[si, k, 0] = g[0]
            pair_geno[si, k, 1] = g[-1]
            pair_pr[si, k] = prior_v[k] - pair_prior_pos(v1, v2)

    # --- filter flank tables (per-hap INS/DEL variant slots, in
    # sorted(h.indels) order — the device computes coverage per slot,
    # the host replays the break/recording order) ---
    pad = params.obs_params.pad_cover
    slot_vars: List[List[Tuple[int, AlignedVariant]]] = []
    vmax = 0
    for h in haps:
        sv = [(p, av) for p, av in sorted(h.indels.items())
              if av.type in (INS, DEL)]
        slot_vars.append(sv)
        vmax = max(vmax, len(sv))
    v_left = np.zeros((nh, vmax), np.int32)
    v_right = np.zeros((nh, vmax), np.int32)
    v_isdel = np.zeros((nh, vmax), bool)
    v_valid = np.zeros((nh, vmax), bool)
    for h, sv in enumerate(slot_vars):
        for v, (p, av) in enumerate(sv):
            v_left[h, v] = av.left_flank_read - pad
            v_right[h, v] = av.right_flank_read + pad
            v_isdel[h, v] = av.type == DEL
            v_valid[h, v] = True

    is_ind = ((np.array(hap_num_candidate_indels)[h1v] > 0)
              | (np.array(hap_num_candidate_indels)[h2v] > 0))

    return dict(
        nh=nh, h1v=h1v, h2v=h2v, npair=npair,
        all_variants=all_variants, all_by_pos=all_by_pos,
        var_positions=var_positions, pos_to_idx=pos_to_idx,
        hap_var=hap_var, var_type=var_type, variants=variants,
        hap_num_indels=hap_num_indels, hap_num_snps=hap_num_snps,
        hap_num_candidate_indels=hap_num_candidate_indels,
        prior_v=prior_v, pair_pr=pair_pr, pair_geno=pair_geno,
        is_ind=is_ind, slot_vars=slot_vars,
        v_left=v_left, v_right=v_right, v_isdel=v_isdel, v_valid=v_valid,
        find_variant=find_variant)


# ---------------------------------------------------------------------------
# Device fold


@partial(jax.jit, static_argnames=("W", "NH", "S", "NR"))
def _window_call(W, NH, S, NR, ll, index_map, nr_w, pair_pr):
    """Per-window read folds over the slab's flat ll vector.

    base[w, k]    = fold_{r<nr_w} of t_r,   t_r = log(.5) + addLogs(l1, l2)
    site[w, s, k] = pair_pr[w, s, k] then the same fold —
    both in the reference's sequential accumulation order (the cumsum in
    diploid_glf); masked reads add +0.0 which is exact.

    index_map (W, NH, NR) int32 maps each padded slot to its flat pair
    index (0 for pad slots — a gather: the map is built on host);
    garbage from pad slots is masked by nr_w here and by pair validity
    on host."""
    dt = pair_pr.dtype
    llc = ll.astype(dt)
    llp = llc[index_map.reshape(-1)].reshape(W, NH, NR)
    h1v, h2v = pair_enum(NH)
    NP = h1v.shape[0]
    log5 = np.array(math.log(0.5), dt)

    def body(carry, x):
        base, site = carry
        lr, r = x                      # lr: (W, NH)
        a = lr[:, h1v]
        b = lr[:, h2v]
        m = jnp.maximum(a, b)
        mn = jnp.minimum(a, b)
        t = log5 + (m + jnp.log(1.0 + jnp.exp(mn - m)))
        t = jnp.where((r < nr_w)[:, None], t, jnp.zeros((), dt))
        base = base + t
        site = site + t[:, None, :]
        return (base, site), None

    base0 = jnp.zeros((W, NP), dt)
    (base, site), _ = lax.scan(
        body, (base0, pair_pr),
        (llp.transpose(2, 0, 1), jnp.arange(NR, dtype=jnp.int32)))
    return base, site


def host_window_folds(ll2d: np.ndarray, ctab: dict):
    """The same folds as _window_call, on host with the anchor caller's
    exact numpy ops.

    Why both exist: XLA's and numpy's float64 exp/log can differ by an
    ulp on ~10% of inputs, which occasionally leaks through
    log(1+exp(x)) into the 6th printed GLF digit.  The byte-parity
    contract (test_callers_ref / golden fixtures) is anchored on the
    numpy/libm side, so whenever x64 is enabled (every parity and CPU
    configuration) the engine uses these host folds; the device fold
    runs in f32 on the device in production, where no byte contract
    applies.
    tests/test_device_call.py::test_window_call_matches_host_folds pins
    the two to ~1e-9."""
    h1v, h2v = ctab["h1v"], ctab["h2v"]
    ll = np.asarray(ll2d, np.float64)
    nr = ll.shape[1]
    log5 = math.log(0.5)
    a = ll[h1v, :]
    b = ll[h2v, :]
    m = np.maximum(a, b)
    mn = np.minimum(a, b)
    T = log5 + (m + np.log(1.0 + np.exp(mn - m)))
    base = (np.cumsum(T, axis=1)[:, -1] if nr
            else np.zeros(len(h1v)))
    S = len(ctab["var_positions"])
    site = np.zeros((S, len(h1v)))
    for s in range(S):
        site[s] = np.cumsum(
            np.concatenate([ctab["pair_pr"][s][None, :], T.T], axis=0),
            axis=0)[-1]
    return base, site


# ---------------------------------------------------------------------------
# Host-side filter replica over device coverage


def filter_haplotypes_dev(haps: List[Haplotype], reads: List[Read],
                          stats, ctab: dict, params: Parameters,
                          do_filter: bool):
    """filter_haplotypes consuming the device cov_ok matrix: identical
    break/recording semantics to the loop implementation
    (DInDel.cpp:1932-2100), with the per-read flank scans already done
    on device."""
    from .filterhaps import _strand

    num_haps = len(haps)
    nr = stats.nr
    filtered = [0] * num_haps
    h_var_cov: Dict[Tuple[int, str], List[set]] = {}
    strand_v = np.array([_strand(r) for r in reads])
    cov3 = stats.cov_ok.reshape(num_haps, nr, -1)

    for h in range(num_haps):
        slot = 0
        sv = {p: v for v, (p, _av) in enumerate(ctab["slot_vars"][h])}
        all_covered = True
        for p, av in sorted(haps[h].indels.items()):
            pav = (p, av.str)
            if pav not in h_var_cov:
                h_var_cov[pav] = [set() for _ in range(num_haps * 2)]
            if av.type not in (INS, DEL):
                continue
            slot = sv[p]
            cov_r = cov3[h, :, slot]
            covered = bool(cov_r.any())
            dst = h_var_cov[pav]
            for r in np.nonzero(cov_r)[0]:
                dst[h + strand_v[r] * num_haps].add(int(r))
            if not covered:
                all_covered = False
                break
        if do_filter and not all_covered:
            filtered[h] = 1

    var_coverage: Dict[Tuple[int, str], Tuple[int, int]] = {}
    for pav, cov_sets in h_var_cov.items():
        rf, rr = set(), set()
        for h in range(num_haps):
            if filtered[h] != 1:
                rf |= cov_sets[h]
                rr |= cov_sets[h + num_haps]
        var_coverage[pav] = (len(rf), len(rr))
    return filtered, var_coverage


# ---------------------------------------------------------------------------
# Diploid caller over device folds


def diploid_glf_dev(haps: List[Haplotype], reads: List[Read], stats,
                    base_ll_full: np.ndarray, site_lls_full: np.ndarray,
                    cand_pos: int, left_pos: int, right_pos: int,
                    glf_data: Optional[OutputData], index: int,
                    ctab: dict, params: Parameters, filtered: List[int],
                    var_coverage: Dict[Tuple[int, str], Tuple[int, int]],
                    program: str = "all") -> List[dict]:
    """diploid_glf (DInDel.cpp:2933-3662) with the read folds replaced by
    the device results: base_ll_full (npair,) and site_lls_full
    (num_var_pos, npair) over the FULL pair enumeration; filtered pairs
    are masked here exactly as the host caller's pair_list excludes
    them."""
    nh = len(haps)
    nr = len(reads)
    rows: List[dict] = []
    A = stats

    h1v = ctab["h1v"]
    h2v = ctab["h2v"]
    hap_var = ctab["hap_var"]
    variants = ctab["variants"]
    var_positions = ctab["var_positions"]
    pos_to_idx = ctab["pos_to_idx"]

    filt_v = np.array(filtered, bool)
    valid_pair = ~(filt_v[h1v] | filt_v[h2v])
    posts_full = base_ll_full + ctab["prior_v"]
    is_ind = ctab["is_ind"]

    ll2d = stats.ll2d

    max_indel_pair = [-1, -1]
    max_noindel_pair = [-1, -1]
    max_ll_indel = NEG
    max_ll_noindel = NEG
    any_valid = bool(valid_pair.any())
    if any_valid:
        # argmax over the VALID slots only (first-max = the host
        # caller's first-valid-pair tie-break): with NEG sentinels in a
        # full-enumeration argmax, a window whose valid posteriors all
        # equal NEG would resolve to slot 0 — possibly a filtered pair —
        # while the host anchor picks the first valid one.
        ind_idx = np.nonzero(valid_pair & is_ind)[0]
        if ind_idx.size:
            k = int(ind_idx[np.argmax(posts_full[ind_idx])])
            max_ll_indel = float(posts_full[k])
            max_indel_pair = [int(h1v[k]), int(h2v[k])]
        noind_idx = np.nonzero(valid_pair & ~is_ind)[0]
        if noind_idx.size:
            k = int(noind_idx[np.argmax(posts_full[noind_idx])])
            max_ll_noindel = float(posts_full[k])
            max_noindel_pair = [int(h1v[k]), int(h2v[k])]

    # MAP call block ("dip.map" rows, DInDel.cpp:3115-3307)
    qual = -10.0 * (max_ll_noindel
                    - add_logs(max_ll_indel, max_ll_noindel)) / math.log(10.0)
    if max_indel_pair[0] == -1 or max_indel_pair[1] == -1:
        raise _WindowThrow("Could not find indel allele")
    hx1, hx2 = max_indel_pair
    unmapped_v = np.array([r.is_unmapped for r in reads], bool)
    off2d = stats.off_hap2d
    num_unmapped_realigned = int(
        (unmapped_v & (~off2d[hx1] | ~off2d[hx2])).sum())

    def _indel_covered(h, p):
        av = haps[h].indels.get(p)
        if av is None:
            return np.zeros(nr, bool)
        fb = stats.fb.reshape(nh, nr)[h]
        lb = stats.lb.reshape(nh, nr)[h]
        pad = params.obs_params.pad_cover
        return (fb + pad <= av.start_read) & (lb - pad >= av.end_read)

    def _snp_covered(h, p):
        av = haps[h].snps.get(p)
        if av is None:
            return np.zeros(nr, bool)
        fb = stats.fb.reshape(nh, nr)[h]
        lb = stats.lb.reshape(nh, nr)[h]
        pad = params.obs_params.pad_cover
        return (fb + pad <= av.start_read) & (lb - pad >= av.end_read)

    def seq_sum(terms) -> float:
        terms = np.asarray(terms, np.float64)
        if terms.size == 0:
            return 0.0
        return float(np.cumsum(terms)[-1])

    indel_sites: Dict[int, List[AlignedVariant]] = {}
    for i in range(2):
        hap = haps[max_indel_pair[i]]
        for p, av in hap.indels.items():
            if (not av.is_ref) or (av.is_snp and len(av.str) > 3
                                   and av.str[3] == "D"):
                lst = indel_sites.setdefault(p, [])
                if not any(x.str == av.str for x in lst):
                    lst.append(av)
    reverse_v = np.array([r.on_reverse_strand for r in reads], bool)
    mq2_v = np.array([(-10.0 * math.log10(1.0 - r.map_qual)) ** 2
                      for r in reads])
    find_variant = ctab["find_variant"]
    for p in sorted(indel_sites):
        alleles = sorted(indel_sites[p], key=lambda a: a.str)
        numf = numr = n = 0
        msq_terms = []
        m = 1 if max_indel_pair[0] == max_indel_pair[1] else 2
        for i in range(m):
            h = max_indel_pair[i]
            it = haps[h].indels.get(p)
            if it is not None and it.is_indel:
                cov = _indel_covered(h, p)
                numf += int((cov & ~reverse_v).sum())
                numr += int((cov & reverse_v).sum())
                n += int(cov.sum())
                msq_terms.append(mq2_v[cov])
        msq = seq_sum(np.concatenate(msq_terms)) if msq_terms else 0.0
        msq = math.sqrt(msq / n) if n != 0 else 0.0

        was_candidate = 0
        vc_f = vc_r = 0
        av0 = alleles[0]
        if find_variant(av0.start_hap + left_pos, av0.type, av0.str):
            was_candidate = 1
        vc = var_coverage.get((p, av0.str), (0, 0))
        vc_f += vc[0]
        vc_r += vc[1]

        a1 = a2 = "*REF"
        a1_ref = a2_ref = True
        it1 = haps[hx1].indels.get(p)
        it2 = haps[hx2].indels.get(p)
        if it1 is not None and not it1.is_ref:
            a1 = it1.str
            a1_ref = False
        if it2 is not None and not it2.is_ref:
            a2 = it2.str
            a2_ref = False
        all_genotype = {a1, a2}
        if a1_ref and a2_ref:
            raise _WindowThrow("genotyping error")
        if a1 == a2:
            genotype = "1/1"
            nref_all = a1
        elif a1_ref:
            genotype = "0/1"
            nref_all = a2
        elif a2_ref:
            genotype = "0/1"
            nref_all = a1
        else:
            nref_all = a1 + "," + a2
            genotype = "1/2"
            av_last = alleles[-1]
            if find_variant(av_last.start_hap + left_pos, av_last.type,
                            av_last.str):
                was_candidate = 1
            vc = var_coverage.get((p, av_last.str), (0, 0))
            vc_f += vc[0]
            vc_r += vc[1]

        # genotype quality vs best alternative genotype
        # (DInDel.cpp:3238-3266), vectorized.  The set comparison is over
        # allele STRINGS (R=>D markers are distinct from *REF there even
        # though they are not in the real-variant inventory), so intern
        # per-hap allele strings at this site and compare id pairs.
        intern: Dict[str, int] = {}
        aid = np.zeros(nh, np.int64)
        for hh in range(nh):
            it = haps[hh].indels.get(p)
            if it is None or it.is_ref:
                aid[hh] = 0
            else:
                aid[hh] = intern.setdefault(it.str, len(intern) + 1)
        g1 = aid[h1v]
        g2 = aid[h2v]
        glo = np.minimum(g1, g2)
        ghi = np.maximum(g1, g2)
        tgt = (min(aid[hx1], aid[hx2]), max(aid[hx1], aid[hx2]))
        same_geno = (glo == tgt[0]) & (ghi == tgt[1])
        is_map_pair = (h1v == hx1) & (h2v == hx2)
        alt_mask = valid_pair & ~is_map_pair & ~same_geno
        max_ll_altgeno = float(np.where(alt_mask, posts_full, NEG).max()) \
            if alt_mask.any() else NEG
        genoqual = -10.0 * (max_ll_altgeno
                            - add_logs(max_ll_indel, max_ll_altgeno)) \
            / math.log(10.0)

        row = dict(msg="ok", index=index, tid=params.tid,
                   analysis_type="dip.map", indidx=0, lpos=left_pos,
                   rpos=right_pos, center_position=cand_pos,
                   realigned_position=p + left_pos,
                   was_candidate_in_window=was_candidate, qual=qual,
                   nref_all=nref_all, num_reads=nr, msq=msq,
                   num_cover_forward=numf, num_cover_reverse=numr,
                   var_coverage_forward=vc_f, var_coverage_reverse=vc_r,
                   num_unmapped_realigned=num_unmapped_realigned,
                   glf=f"{genotype}:{_g(genoqual)}")
        rows.append(row)
        _emit(glf_data, row)

    # per-site genotype marginals ("dip" rows, DInDel.cpp:3310-3660)
    for p in var_positions:
        pos_idx = pos_to_idx[p]
        has_variants_in_window = 0
        for (pp, av) in ctab["all_by_pos"][p]:
            if find_variant(av.start_hap + left_pos, av.type, av.str):
                has_variants_in_window = 1
                break
        lls_full = site_lls_full[pos_idx]
        pg = ctab["pair_geno"][pos_idx]
        gen_liks: Dict[Tuple[int, ...], float] = {}
        maxll = NEG
        ghx1 = ghx2 = 0
        for k in np.nonzero(valid_pair)[0]:
            ll = float(lls_full[k])
            v1, v2 = int(pg[k, 0]), int(pg[k, 1])
            genotype = (v1,) if v1 == v2 else (v1, v2)
            if genotype in gen_liks:
                gen_liks[genotype] = add_logs(gen_liks[genotype], ll)
            else:
                gen_liks[genotype] = ll
            if ll > maxll:
                maxll = ll
                ghx1, ghx2 = int(h1v[k]), int(h2v[k])

        num_unmapped_realigned2 = int(
            (unmapped_v & (~off2d[ghx1] | ~off2d[ghx2])).sum())

        use1 = ll2d[ghx1] >= ll2d[ghx2]
        allmsq = seq_sum(mq2_v)

        def _2d(a):
            return np.asarray(a).reshape(nh, nr)

        def _pick(a2d):
            return np.where(use1, a2d[ghx1], a2d[ghx2])

        num_off_both = int((off2d[ghx1] & off2d[ghx2]).sum())
        num_mapped_indels = int(np.where(
            use1, A.n_indel_entries_row(ghx1),
            A.n_indel_entries_row(ghx2)).sum())
        n_bqt = int(_pick(_2d(A.n_bqt)).sum())
        nmm_bqt = int(_pick(_2d(A.n_mm_bqt)).sum())
        m_log_bq = seq_sum(_pick(_2d(A.m_log_bq)))
        n_mm_left = int((_pick(_2d(A.n_mm_left)) >= 2).sum())
        n_mm_right = int((_pick(_2d(A.n_mm_right)) >= 2).sum())

        def _cov_at(h):
            hit = haps[h].indels.get(p)
            if hit is not None and hit.is_indel:
                return _indel_covered(h, p)
            if hit is not None and hit.is_snp:
                return _snp_covered(h, p)
            return np.zeros(nr, bool)

        cov = np.where(use1, _cov_at(ghx1), _cov_at(ghx2))
        nf = int((cov & ~reverse_v).sum())
        nr_count = int((cov & reverse_v).sum())
        n = int(cov.sum())
        msq = seq_sum(mq2_v[cov])
        msq = math.sqrt(msq / n) if n != 0 else 0.0
        allmsq = math.sqrt(allmsq / nr) if nr != 0 else 0.0

        to_vcf_idx = {0: 0}
        nidx = 1
        o_alleles = []
        o_cov_f = []
        o_cov_r = []
        for h in range(nh):
            v = int(hap_var[h, pos_idx])
            if v != 0 and v not in to_vcf_idx:
                to_vcf_idx[v] = nidx
                nidx += 1
                pav = variants[v]
                o_alleles.append(pav[1].str)
                vc = var_coverage.get((pav[0], pav[1].str), (0, 0))
                o_cov_f.append(str(vc[0]))
                o_cov_r.append(str(vc[1]))

        glf_parts = []
        for genotype in sorted(gen_liks):
            v1, v2 = genotype[0], genotype[-1]
            a1 = to_vcf_idx[v1]
            a2 = to_vcf_idx[v2]
            glf_parts.append(f"{a1}/{a2}:{_g(gen_liks[genotype])}")

        row = dict(msg="ok", index=index, tid=params.tid,
                   analysis_type=program, indidx=0, lpos=left_pos,
                   rpos=right_pos, center_position=cand_pos,
                   realigned_position=p + left_pos,
                   was_candidate_in_window=has_variants_in_window,
                   logZ=maxll, nBQT=n_bqt, nmmBQT=nmm_bqt,
                   # nBQT==0 implies mLogBQ==0.0 (no bases passed the quality
                   # threshold), and the reference's 0.0/0.0 is the x86
                   # default QNaN with the SIGN BIT SET — printed "-nan"
                   # (DInDel.cpp:3635)
                   mLogBQ=(m_log_bq / n_bqt) if n_bqt else float("-nan"),
                   nMMLeft=n_mm_left, nMMRight=n_mm_right,
                   nref_all=",".join(o_alleles), num_reads=nr, msq=allmsq,
                   numOffAll=num_off_both, num_indel=num_mapped_indels,
                   num_cover_forward=nf, num_cover_reverse=nr_count,
                   var_coverage_forward=",".join(o_cov_f),
                   var_coverage_reverse=",".join(o_cov_r),
                   glf=",".join(glf_parts),
                   num_unmapped_realigned=num_unmapped_realigned2)
        rows.append(row)
        if params.output_glf:
            _emit(glf_data, row)
    return rows
