"""Batched pair-HMM: scores every (haplotype, read) pair of a window in
one device program.

Numerical contract: ObservationModelFBMaxErr (see hmm/reference.py, which
this module must match bit-for-bit in float64). Design notes:

- Fixed state layout per bucket: x in {0=LO, 1..H_pad, H_pad+1=RO} x
  insertion flag; per-pair true hap length Hh < H_pad is handled by mapping
  "beyond hap end" to the fixed RO index (gather-free via shifted V-arrays)
  and by masking dead states to -1e30 every step.
- The reference runs the forward (Dec) recursion only up to the per-read
  anchor bMid and the backward (Inc) recursion down to it.  We run both
  recursions over the full read uniformly (SPMD-friendly; 2x the minimal
  work but no data-dependent trip counts) and select the bMid slice per
  pair on the fly.
- updateMax's EPS/tie-to-lower-index rule (ObservationModelFB.cpp:877-888)
  is reproduced exactly by folding candidates in the reference's program
  order; the bMid-slice likelihood fold (:1096-1117) is an order-dependent
  scan over states and is emulated with lax.scan.
- Backpointers for both directions are stored (L x B x S int16) and the
  MAP path is reconstructed with two short scans; per-read variant events
  are extracted on host by the vectorized decode_map_alignments (parity
  with hmm/reference._report_variants, tests/test_report_fast.py).

The DP recursions have two interchangeable implementations: pure-XLA scans
(_dp_xla — runs anywhere, float64 bit-parity on CPU) and a fused kernel
(hmm/fused.py — CUDA on the GPU, a host build of the same code on CPU,
float32, bit-identical to _dp_xla).  The likelihood folds + backtrack
(_finish) are shared.
"""

from __future__ import annotations

import math
from functools import partial
from typing import List, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import ObservationModelParameters
from ..model import Haplotype, MLAlignment, Read
from .reference import (EPS, TIE, _Trans, compute_b_mid,
                        compute_b_mid_prior, hp_log_prob_error)

NEGBIG = -1.0e30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _fold(dest_v, dest_i, cand_v, cand_i):
    """One updateMax step, vectorized (exact port of
    ObservationModelFB.cpp:877-888)."""
    take = cand_v > dest_v + EPS
    tie = (cand_v >= dest_v) & (cand_v <= dest_v + TIE) & (dest_i > cand_i)
    take = take | tie
    return jnp.where(take, cand_v, dest_v), jnp.where(take, cand_i, dest_i)


@partial(jax.jit, static_argnames=("H_pad", "L_pad", "numT"))
def _dp_xla(H_pad, L_pad, numT,
            hap_len, read_len, b_mid, read_codes, hap_codes,
            eq, uq, lpe, lpn, lpeV, lpnV, scalars):
    """XLA-scan implementation of the two DP recursions.
    Returns (alpha_mid, beta_mid, btf, btb); btf[b-1] are the forward
    backpointers of slice b (b=1..L_pad-1), btb[b] the backward successors
    of slice b (b=0..L_pad-2)."""
    B = hap_len.shape[0]
    S_half = H_pad + 2
    S = 2 * S_half
    RO = H_pad + 1
    dtype = eq.dtype

    logpLOgLO, logpFirstgLO, logpInsgIns, logpNoInsgIns, logpNoInsgNoIns = (
        scalars[0], scalars[1], scalars[2], scalars[3], scalars[4])

    xs_state = jnp.arange(S_half, dtype=jnp.int32)[None, :]
    live = (xs_state <= hap_len[:, None]) | (xs_state == RO)
    live2 = jnp.concatenate([live, live], axis=1)
    idx_base = jnp.arange(S, dtype=jnp.int32)[None, :].repeat(B, 0)
    j_idx = jnp.arange(S_half + numT, dtype=jnp.int32)[None, :]
    idxV = jnp.where(j_idx <= hap_len[:, None], j_idx, RO)
    hl = hap_len[:, None]

    def obs_slice(b):
        rb = read_codes[:, b][:, None]
        e = eq[:, b][:, None]
        u = uq[:, b][:, None]
        mismatch = (hap_codes != rb) & (hap_codes != ord("N"))
        on = jnp.where(mismatch, u, e)
        noins = jnp.concatenate([e, on, e], axis=1)
        ins = jnp.broadcast_to(e, (B, S_half)).astype(dtype)
        return jnp.concatenate([noins, ins], axis=1)

    def gather_col(M, col):
        return jnp.take_along_axis(M, col[:, None], axis=1)[:, 0]

    # Dec pass (FBMaxErr::passMessageTwoDec, ObservationModelFB.cpp:1775-1829)
    def dec_step(A, O):
        W = A + O
        Wn = W[:, :S_half]
        Wi = W[:, S_half:]
        dRO_v = jnp.full((B,), NEGBIG, dtype=dtype)
        dRO_i = jnp.full((B,), RO, dtype=jnp.int32)
        dRO_v, dRO_i = _fold(dRO_v, dRO_i,
                             W[:, RO] + logpLOgLO + logpNoInsgNoIns,
                             jnp.full((B,), RO, jnp.int32))
        WnH = gather_col(Wn, hap_len)
        dRO_v, dRO_i = _fold(dRO_v, dRO_i,
                             WnH + logpFirstgLO + logpNoInsgNoIns, hap_len)
        dx_v = jnp.full((B, S_half), NEGBIG, dtype=dtype)
        dx_i = idx_base[:, :S_half]
        x_idx = xs_state
        for y in range(1, numT):
            src_idx = jnp.maximum(x_idx - y, 0)
            srcW = jnp.take_along_axis(
                Wn, jnp.broadcast_to(src_idx, (B, S_half)), axis=1)
            lp = lpn if y == 1 else (lpe + (y - 1) * logpInsgIns)
            cand = srcW + lp + lpn
            dx_v, dx_i = _fold(dx_v, dx_i, cand,
                               jnp.broadcast_to(src_idx, (B, S_half)))
        d0_v = W[:, 0] + logpNoInsgNoIns
        d0_i = jnp.zeros((B,), jnp.int32)
        dRO_v, dRO_i = _fold(dRO_v, dRO_i,
                             W[:, S_half + RO] + logpLOgLO + lpe[:, RO],
                             jnp.full((B,), S_half + RO, jnp.int32))
        WiH = gather_col(Wi, hap_len)
        lpeH = gather_col(lpe, hap_len)
        dRO_v, dRO_i = _fold(dRO_v, dRO_i,
                             WiH + logpFirstgLO + lpeH, S_half + hap_len)
        src_idx = jnp.maximum(x_idx - 1, 0)
        srcWi = jnp.take_along_axis(
            Wi, jnp.broadcast_to(src_idx, (B, S_half)), axis=1)
        cand = srcWi + lpe
        dx_v, dx_i = _fold(dx_v, dx_i, cand,
                           S_half + jnp.broadcast_to(src_idx, (B, S_half)))
        di_v = Wi + logpInsgIns
        di_i = idx_base[:, S_half:]
        open_cand = Wn + logpNoInsgIns
        open_ok = (x_idx >= 1)
        di_v, di_i = _fold(di_v, di_i,
                           jnp.where(open_ok, open_cand, NEGBIG),
                           jnp.where(open_ok, idx_base[:, :S_half], di_i))
        noins_v = dx_v.at[:, 0].set(d0_v).at[:, RO].set(dRO_v)
        noins_i = dx_i.at[:, 0].set(d0_i).at[:, RO].set(dRO_i)
        newA = jnp.concatenate([noins_v, di_v], axis=1)
        newI = jnp.concatenate([noins_i, di_i], axis=1)
        newA = jnp.where(live2, newA, NEGBIG)
        newI = jnp.where(live2, newI, idx_base)
        return newA, newI

    # Inc pass (FBMaxErr::passMessageTwoInc, ObservationModelFB.cpp:1715-1773)
    def inc_step(Bt, O):
        W = Bt + O
        Wn = W[:, :S_half]
        Wi = W[:, S_half:]
        WnRO = Wn[:, RO][:, None]
        Vn_core = jnp.where(xs_state <= hl, Wn, WnRO)
        Vn = jnp.concatenate(
            [Vn_core, jnp.broadcast_to(WnRO, (B, numT)).astype(dtype)], axis=1)
        x_idx = xs_state
        d0_v = jnp.full((B,), NEGBIG, dtype=dtype)
        d0_i = jnp.zeros((B,), jnp.int32)
        d0_v, d0_i = _fold(d0_v, d0_i,
                           W[:, 0] + logpLOgLO + logpNoInsgNoIns,
                           jnp.zeros((B,), jnp.int32))
        d0_v, d0_i = _fold(d0_v, d0_i,
                           W[:, 1] + logpFirstgLO + logpNoInsgNoIns,
                           jnp.ones((B,), jnp.int32))
        dx_v = jnp.full((B, S_half), NEGBIG, dtype=dtype)
        dx_i = idx_base[:, :S_half]
        for y in range(1, numT):
            srcW = lax.dynamic_slice_in_dim(Vn, y, S_half, axis=1)
            src_lpn = lax.dynamic_slice_in_dim(lpnV, y, S_half, axis=1)
            src_lpe = lax.dynamic_slice_in_dim(lpeV, y, S_half, axis=1)
            src_i = lax.dynamic_slice_in_dim(idxV, y, S_half, axis=1)
            lp = src_lpn if y == 1 else (src_lpe + (y - 1) * logpInsgIns)
            cand = lp + src_lpn + srcW
            dx_v, dx_i = _fold(dx_v, dx_i, cand, src_i)
        dRO_v = jnp.full((B,), NEGBIG, dtype=dtype)
        dRO_i = jnp.full((B,), RO, jnp.int32)
        dRO_v, dRO_i = _fold(dRO_v, dRO_i, W[:, RO] + lpn[:, RO],
                             jnp.full((B,), RO, jnp.int32))
        lpe_x1 = jnp.concatenate(
            [lpe[:, 1:], jnp.zeros((B, 1), dtype)], axis=1)
        cost = jnp.where(x_idx == RO, jnp.zeros((), dtype), lpe_x1)
        cand = Wi + cost
        dx_v, dx_i = _fold(dx_v, dx_i, cand, S_half + idx_base[:, :S_half])
        dx0_v, dx0_i = _fold(d0_v, d0_i, cand[:, 0],
                             jnp.full((B,), S_half + 0, jnp.int32))
        dxRO_v, dxRO_i = _fold(dRO_v, dRO_i, cand[:, RO],
                               jnp.full((B,), S_half + RO, jnp.int32))
        di_v = Wi + logpInsgIns
        di_i = idx_base[:, S_half:]
        di0_v, di0_i = _fold(di_v[:, 0], di_i[:, 0],
                             Wn[:, 0] + logpNoInsgIns,
                             jnp.zeros((B,), jnp.int32))
        srcW = lax.dynamic_slice_in_dim(Vn, 1, S_half, axis=1)
        src_i = lax.dynamic_slice_in_dim(idxV, 1, S_half, axis=1)
        exit_ok = x_idx >= 1
        di_v, di_i = _fold(di_v, di_i,
                           jnp.where(exit_ok, srcW + logpNoInsgIns, NEGBIG),
                           jnp.where(exit_ok, src_i, di_i))
        di_v = di_v.at[:, 0].set(di0_v)
        di_i = di_i.at[:, 0].set(di0_i)
        noins_v = dx_v.at[:, 0].set(dx0_v).at[:, RO].set(dxRO_v)
        noins_i = dx_i.at[:, 0].set(dx0_i).at[:, RO].set(dxRO_i)
        newB = jnp.concatenate([noins_v, di_v], axis=1)
        newI = jnp.concatenate([noins_i, di_i], axis=1)
        newB = jnp.where(live2, newB, NEGBIG)
        newI = jnp.where(live2, newI, idx_base)
        return newB, newI

    zero_state = jnp.zeros((B, S), dtype=dtype)
    idx_base16 = idx_base.astype(jnp.int16)

    def fwd_body(carry, b):
        A, a_mid = carry
        O = obs_slice(b - 1)
        newA, btf_b = dec_step(A, O)
        a_mid = jnp.where((b_mid == b)[:, None], newA, a_mid)
        return (newA, a_mid), btf_b.astype(jnp.int16)

    (_, alpha_mid), btf = lax.scan(
        fwd_body, (zero_state, zero_state), jnp.arange(1, L_pad))

    def bwd_body(carry, b):
        Bt, b_mid_acc = carry
        O = obs_slice(b)
        newB, btb_b = inc_step(Bt, O)
        pad = ((b - 1) >= (read_len - 1))[:, None]
        newB = jnp.where(pad, zero_state, newB)
        btb_b = jnp.where(pad, idx_base, btb_b)
        b_mid_acc = jnp.where((b_mid == (b - 1))[:, None], newB, b_mid_acc)
        return (newB, b_mid_acc), btb_b.astype(jnp.int16)

    (_, beta_mid), btb_rev = lax.scan(
        bwd_body, (zero_state, zero_state), jnp.arange(L_pad - 1, 0, -1))
    beta_mid = jnp.where((b_mid == (L_pad - 1))[:, None], zero_state, beta_mid)
    btb = btb_rev[::-1]
    return alpha_mid, beta_mid, btf, btb


@partial(jax.jit, static_argnames=("H_pad", "L_pad", "exact_ties",
                                   "bt_codes", "numT"))
def _finish(H_pad, L_pad, b_mid,
            alpha_mid, beta_mid, obs_mid, prior_rmq, prior_hmq, btf, btb,
            exact_ties=True, bt_codes=False, numT=0, hap_len=None):
    """bMid-slice likelihood folds (calcLikelihoodFromLastSlice,
    ObservationModelFB.cpp:1075-1144) + MAP-state reconstruction.

    bt_codes=False: btf/btb are full source-state indices (the _dp_xla
    format).  bt_codes=True: they are the fused kernel's byte-packed
    4-bit transition-class codes, (L-1, B, S_half); the source index is
    reconstructed from (code, current state, hap_len) on the fly (decode
    tables in fused.expand_bt_codes's docstring) — requires hap_len and
    numT.

    exact_ties=True emulates the reference's order-dependent EPS-guarded
    fold (:1096-1117) with a sequential lax.scan over all 2*(H_pad+2)
    states.  exact_ties=False replaces it with a parallel first-occurrence
    argmax: the fold's `v > ll + EPS` guard degenerates to a strict `>`
    whenever EPS (1e-10) is below one ulp of the running maximum — true in
    float32 for any |ll| >= ~0.01, i.e. every realistic log-likelihood —
    and a strict-> fold with first-index-wins ties IS argmax."""
    B = b_mid.shape[0]
    S_half = H_pad + 2
    S = 2 * S_half
    RO = H_pad + 1
    dtype = alpha_mid.dtype

    base = alpha_mid + obs_mid + beta_mid
    vr = base + prior_rmq
    vh = base + prior_hmq

    if not exact_ties:
        map_rmq = jnp.argmax(vr, axis=1).astype(jnp.int32)
        ll = jnp.max(vr, axis=1)
        s_mid = jnp.argmax(vh, axis=1).astype(jnp.int32)
        ll_hmq = jnp.max(vh, axis=1)
        xm = jnp.arange(S, dtype=jnp.int32) % S_half
        is0 = (xm == 0)[None, :]
        isRO = (xm == RO)[None, :]
        neginf = jnp.array(-jnp.inf, dtype=dtype)
        ll_off = jnp.max(jnp.where(is0, vr, neginf), axis=1)
        ll_on = jnp.max(jnp.where(is0 | isRO, neginf, vr), axis=1)
    else:
        def lik_fold(carry, x):
            ll, idxR, llH, idxH, off0, off1 = carry
            v = vr[:, x]
            w = vh[:, x]
            takeR = v > ll + EPS
            ll = jnp.where(takeR, v, ll)
            idxR = jnp.where(takeR, x, idxR)
            takeH = w > llH + EPS
            llH = jnp.where(takeH, w, llH)
            idxH = jnp.where(takeH, x, idxH)
            xm = x % S_half
            is0 = xm == 0
            isRO = xm == RO
            off0 = jnp.where(is0 & (v > off0), v, off0)
            off1 = jnp.where((~is0) & (~isRO) & (v > off1), v, off1)
            return (ll, idxR, llH, idxH, off0, off1), None

        neg = jnp.full((B,), -jnp.inf, dtype=dtype)
        zero_i = jnp.zeros((B,), jnp.int32)
        (ll, map_rmq, ll_hmq, s_mid, ll_off, ll_on), _ = lax.scan(
            lik_fold, (neg, zero_i, neg, zero_i, neg, neg),
            jnp.arange(S, dtype=jnp.int32), unroll=8)

    if bt_codes:
        hl = hap_len.astype(jnp.int32)

        def code_at(bt_b, cur):
            x = cur % S_half
            pack = jnp.take_along_axis(bt_b, x[:, None],
                                       axis=1)[:, 0].astype(jnp.int32)
            c = jnp.where(cur >= S_half, pack >> 4, pack) & 15
            return x, c

        def decode_fwd(bt_b, cur):
            x, c = code_at(bt_b, cur)
            ins_nxt = jnp.where(c == 0, cur, x)
            noins_int = jnp.where(c == 0, S_half + jnp.maximum(x - 1, 0),
                                  jnp.where(c == 1, x,
                                            jnp.maximum(x - (c - 1), 0)))
            noins_ro = jnp.where(c == 0, S_half + RO,
                                 jnp.where(c == 1, S_half + hl,
                                           jnp.where(c == 2, RO, hl)))
            noins_nxt = jnp.where(x == RO, noins_ro, noins_int)
            return jnp.where(cur >= S_half, ins_nxt, noins_nxt)

        def decode_bwd(bt_b, cur):
            x, c = code_at(bt_b, cur)
            x1 = jnp.where(x + 1 <= hl, x + 1, RO)
            ins_nxt = jnp.where(c == 0, cur, jnp.where(c == 1, x, x1))
            xy = x + (numT - c)
            dely = jnp.where(xy <= hl, xy, RO)
            noins_nxt = jnp.where(c == 0, S_half + x,
                                  jnp.where(c == numT, x, dely))
            return jnp.where(cur >= S_half, ins_nxt, noins_nxt)
    else:
        def decode_fwd(bt_b, cur):
            return jnp.take_along_axis(bt_b.astype(jnp.int32),
                                       cur[:, None], axis=1)[:, 0]

        decode_bwd = decode_fwd

    def down_body(cur, t):
        b = t
        nxt = decode_fwd(btf[b - 1], cur)
        cur2 = jnp.where(b <= b_mid, nxt, cur)
        return cur2, cur2

    _, down_states = lax.scan(down_body, s_mid,
                              jnp.arange(L_pad - 1, 0, -1))
    down_states = down_states[::-1]

    def up_body(cur, b):
        nxt = decode_bwd(btb[b], cur)
        cur2 = jnp.where(b >= b_mid, nxt, cur)
        return cur2, cur2

    _, up_states = lax.scan(up_body, s_mid, jnp.arange(0, L_pad - 1))

    b_axis = jnp.arange(L_pad, dtype=jnp.int32)[None, :]
    ms_down = jnp.concatenate([down_states.transpose(1, 0),
                               s_mid[:, None]], axis=1)
    ms_up = jnp.concatenate([s_mid[:, None],
                             up_states.transpose(1, 0)], axis=1)
    map_state = jnp.where(b_axis < b_mid[:, None], ms_down,
                          jnp.where(b_axis > b_mid[:, None], ms_up,
                                    s_mid[:, None]))

    off_hap_hmq = ((s_mid % S_half) == 0) | ((s_mid % S_half) == RO)
    off_hap = ((map_rmq % S_half) == 0) | ((map_rmq % S_half) == RO)
    return ll, off_hap, off_hap_hmq, ll_off, ll_on, map_state


def compute_obs_mid(pk: dict) -> np.ndarray:
    """Observation potentials at each pair's bMid slice, host-side
    (setupReadObservationPotentials at one slice)."""
    B = pk["hap_len"].shape[0]
    H_pad = pk["H_pad"]
    S_half = H_pad + 2
    bm = pk["b_mid"]
    rows = np.arange(B)
    e = pk["eq"][rows, bm][:, None]
    u = pk["uq"][rows, bm][:, None]
    rb = pk["read_codes"][rows, bm][:, None]
    mismatch = (pk["hap_codes"] != rb) & (pk["hap_codes"] != ord("N"))
    on = np.where(mismatch, u, e)
    noins = np.concatenate([e, on, e * np.ones((B, 1))], axis=1)
    ins = np.broadcast_to(e, (B, S_half))
    return np.concatenate([noins, ins], axis=1).astype(pk["eq"].dtype)


def get_dp_impl(name: str):
    if name == "xla":
        return _dp_xla
    if name == "fused":
        from .fused import dp_fused
        return dp_fused
    raise ValueError(name)


def run_packed(pk: dict, dp_impl: str = "xla", exact_ties: bool = None):
    """Run DP + finish on a packed dict; returns device outputs
    (ll, off_hap, off_hap_hmq, ll_off, ll_on, map_state).

    exact_ties=None picks per impl: XLA (the float64 oracle-parity path)
    keeps the exact sequential likelihood fold; the fused float32 kernel
    uses the parallel argmax finish."""
    if exact_ties is None:
        exact_ties = (dp_impl == "xla")
    dp = get_dp_impl(dp_impl)
    alpha_mid, beta_mid, btf, btb = dp(
        pk["H_pad"], pk["L_pad"], pk["numT"],
        jnp.asarray(pk["hap_len"]), jnp.asarray(pk["read_len"]),
        jnp.asarray(pk["b_mid"]), jnp.asarray(pk["read_codes"]),
        jnp.asarray(pk["hap_codes"]), jnp.asarray(pk["eq"]),
        jnp.asarray(pk["uq"]), jnp.asarray(pk["lpe"]), jnp.asarray(pk["lpn"]),
        jnp.asarray(pk["lpeV"]), jnp.asarray(pk["lpnV"]),
        pk["scalars"])
    obs_mid = jnp.asarray(compute_obs_mid(pk))
    out = _finish(pk["H_pad"], pk["L_pad"], jnp.asarray(pk["b_mid"]),
                  alpha_mid, beta_mid, obs_mid,
                  jnp.asarray(pk["prior_rmq"]), jnp.asarray(pk["prior_hmq"]),
                  btf, btb, exact_ties=exact_ties,
                  bt_codes=(dp_impl == "fused"), numT=pk["numT"],
                  hap_len=jnp.asarray(pk["hap_len"]))
    # map_state values < 2*(H_pad+2): ship int16 when that fits (halves
    # the biggest host fetch)
    if 2 * (pk["H_pad"] + 2) < 2 ** 15:
        out = out[:-1] + (out[-1].astype(jnp.int16),)
    return out


# ---------------------------------------------------------------------------
# Compact packing: per-read / per-hap tables + per-pair indices.
#
# The dense pk ships ~7.5 KB per (hap, read) pair to the device — mostly
# per-hap rows repeated per read (lpe/lpn/hap_codes/priors) and per-read
# rows repeated per hap (eq/uq/read_codes).  The compact form ships each
# table once plus two (B,) int32 index vectors and expands ON DEVICE with
# gathers; the bMid priors and obs_mid
# slice are also assembled on device from host-computed per-read scalars
# (pure gathers/selects of host values — bit-identical to the dense path,
# tests/test_pack_vectorized.py::test_compact_matches_dense).
#
# The insert-size positional prior (map_unmapped_reads + eligible mates)
# needs per-pair pinsert tables; pack_pairs_compact returns None there and
# callers fall back to the dense path.

def pack_pairs_compact(haps: List[Haplotype], reads: List[Read],
                       hap_start: int, p: ObservationModelParameters,
                       dtype=np.float64, bucket: int = 16,
                       H_pad: int = None, L_pad: int = None):
    if p.map_unmapped_reads and any(
            r.is_paired and not r.mate_is_unmapped and r.mate_len != -1
            and r.same_tid_as_mate for r in reads):
        return None
    nh, nr = len(haps), len(reads)
    H_max = max(h.size() for h in haps)
    L_max = max(r.size() for r in reads)
    if H_pad is None:
        H_pad = _round_up(H_max, bucket)
    if L_pad is None:
        L_pad = _round_up(max(L_max, 2), bucket)
    numT = p.max_length_del + 2
    S_half = H_pad + 2

    # per-read tables
    read_len_r = np.fromiter((r.size() for r in reads), np.int32, nr)
    read_codes_r = np.zeros((nr, L_pad), np.uint8)
    qual_r = np.zeros((nr, L_pad), np.float64)
    for ri, r in enumerate(reads):
        L = read_len_r[ri]
        read_codes_r[ri, :L] = np.frombuffer(r.seq.encode(), np.uint8)
        qual_r[ri, :L] = r.qual
    col = np.arange(L_pad)[None, :]
    in_read = col < read_len_r[:, None]
    pr = qual_r * (1.0 - p.p_mut)
    eq_r = np.where(in_read, np.log(0.25 + 0.75 * pr), 0.0).astype(dtype)
    uq_r = np.where(in_read, np.log(0.75 + 1e-10 - 0.75 * pr),
                    0.0).astype(dtype)
    map_qual_r = np.fromiter((r.map_qual for r in reads), np.float64, nr)
    unmapped_r = np.fromiter((r.is_unmapped for r in reads), bool, nr)
    psf_r = np.fromiter((read.pos_stat_first for read in reads),
                        np.float64, nr)
    # capped off-hap prior mass per read (computeBMidPrior,
    # ObservationModelFB.cpp:268-305)
    mq = 1.0 - map_qual_r
    capped = -10.0 * np.log10(mq) > p.map_qual_threshold
    mq = np.where(capped, 10.0 ** (-p.map_qual_threshold / 10.0), mq)
    log_off_r = np.log(mq)
    log_on_r = np.log(1.0 - mq)
    # HMQ prior mass: same float ops as the dense path (1-(1-1e-10)
    # differs from literal 1e-10 by one ulp, and the cap threshold
    # comparison sits exactly at that boundary)
    mq_h = 1.0 - (1.0 - 1e-10)
    if -10.0 * math.log10(mq_h) > p.map_qual_threshold:
        mq_h = 10.0 ** (-p.map_qual_threshold / 10.0)
    tr_dummy = _Trans(p, haps[0].seq)

    # per-hap tables
    hap_len_h = np.fromiter((h.size() for h in haps), np.int32, nh)
    hap_codes_h = np.zeros((nh, H_pad), np.uint8)
    lpe_h = np.full((nh, S_half), math.log(1e-5), dtype)
    lpn_h = np.full((nh, S_half), math.log(1 - 1e-5), dtype)
    lpeV_h = np.zeros((nh, S_half + numT), dtype)
    lpnV_h = np.zeros((nh, S_half + numT), dtype)
    b_mid_hr = np.zeros((nh, nr), np.int32)
    for hi, hap in enumerate(haps):
        Hh = hap_len_h[hi]
        if p.max_length_del > Hh:
            raise ValueError("hapSize error.")
        hap_codes_h[hi, :Hh] = np.frombuffer(hap.seq.encode(), np.uint8)
        e_, n_ = hp_log_prob_error(hap.seq)
        lpe_h[hi, :Hh + 2] = np.asarray(e_, dtype)
        lpn_h[hi, :Hh + 2] = np.asarray(n_, dtype)
        ROi = Hh + 1
        if ROi != H_pad + 1:
            lpe_h[hi, H_pad + 1] = lpe_h[hi, ROi]
            lpn_h[hi, H_pad + 1] = lpn_h[hi, ROi]
        core_e = np.full(S_half + numT, e_[ROi])
        core_n = np.full(S_half + numT, n_[ROi])
        core_e[:Hh + 1] = e_[:Hh + 1]
        core_n[:Hh + 1] = n_[:Hh + 1]
        lpeV_h[hi] = core_e
        lpnV_h[hi] = core_n
        # vectorized compute_b_mid (ObservationModelFB.cpp:50-99)
        m = psf_r.astype(np.int64)
        read_end = m + read_len_r - 1
        hap_end = hap_start + int(Hh)
        ol_start = np.maximum(hap_start, m)
        ol_end = np.where(hap_end > read_end, read_end, hap_end)
        mid = (ol_end - ol_start) // 2 + ol_start
        bm = np.where(unmapped_r | (m > hap_end) | (read_end < hap_start),
                      read_len_r // 2, mid - m)
        if p.b_mid != -1:
            bm = np.full_like(bm, p.b_mid)
        b_mid_hr[hi] = np.clip(bm, 0, read_len_r - 1).astype(np.int32)

    hap_idx = np.repeat(np.arange(nh, dtype=np.int32), nr)
    read_idx = np.tile(np.arange(nr, dtype=np.int32), nh)
    scalars = np.array([math.log(1.0 - p.p_first_g_lo),
                        math.log(p.p_first_g_lo),
                        -0.5,
                        math.log(1.0 - math.exp(-0.5)),
                        math.log(1.0 - p.p_error)], dtype)
    # per-read-base tables for the device stats pass (_pair_stats):
    # base-quality masks + log10(1-q) terms (in_read masking matches the
    # host decode, which only reads b < read_len)
    bqt_r = in_read & (qual_r > p.check_base_qual_threshold)
    q95_r = in_read & (qual_r > 0.95)
    with np.errstate(divide="ignore"):
        log10q_r = np.where(in_read,
                            np.log10(np.maximum(1.0 - qual_r, 1e-300)), 0.0)
    return dict(
        compact=True, H_pad=H_pad, L_pad=L_pad, numT=numT, nh=nh, nr=nr,
        bqt_r=bqt_r, q95_r=q95_r, log10q_r=log10q_r,
        read_codes_r=read_codes_r, eq_r=eq_r, uq_r=uq_r,
        hap_codes_h=hap_codes_h, lpe_h=lpe_h, lpn_h=lpn_h,
        lpeV_h=lpeV_h, lpnV_h=lpnV_h,
        hap_idx=hap_idx, read_idx=read_idx,
        hap_len=hap_len_h[hap_idx], read_len=read_len_r[read_idx],
        b_mid=b_mid_hr.reshape(-1),
        log_off_r=log_off_r, log_on_r=log_on_r,
        log_off_hmq=math.log(mq_h), log_on_hmq=math.log(1.0 - mq_h),
        log_ins1=tr_dummy.logpInsgNoIns,
        log_ins0=math.log(1.0 - math.exp(tr_dummy.logpInsgNoIns)),
        scalars=scalars)


def merge_compact(pks: List[dict]) -> dict:
    """Concatenate compact pks from several windows into one slab (table
    rows stacked; per-pair indices offset)."""
    if len(pks) == 1:
        return pks[0]
    out = dict(pks[0])
    for key in ("H_pad", "L_pad", "numT"):
        assert all(pk[key] == out[key] for pk in pks)
    tables_r = ("read_codes_r", "eq_r", "uq_r", "log_off_r", "log_on_r",
                "bqt_r", "q95_r", "log10q_r")
    tables_h = ("hap_codes_h", "lpe_h", "lpn_h", "lpeV_h", "lpnV_h")
    for k in tables_r + tables_h:
        out[k] = np.concatenate([pk[k] for pk in pks])
    off_r = np.cumsum([0] + [pk["read_codes_r"].shape[0] for pk in pks])
    off_h = np.cumsum([0] + [pk["hap_codes_h"].shape[0] for pk in pks])
    out["read_idx"] = np.concatenate(
        [pk["read_idx"] + off_r[i] for i, pk in enumerate(pks)])
    out["hap_idx"] = np.concatenate(
        [pk["hap_idx"] + off_h[i] for i, pk in enumerate(pks)])
    for k in ("hap_len", "read_len", "b_mid"):
        out[k] = np.concatenate([pk[k] for pk in pks])
    out["nh"] = out["nr"] = 0
    return out


def pad_compact(pk: dict) -> dict:
    """Pad a compact slab's table and pair-array sizes to shape buckets
    so the expand/DP/finish jits recur instead of recompiling per slab
    (each cold compile is seconds; the pad rows are clones of the last
    real row and every consumer slices by real-pair offsets).  Read
    tables pad to multiples of 64 rows, hap tables to 8, and the pair
    axis to 128-pair blocks, a power of two of them below 16 and a
    multiple of 16 above."""
    def padrows(a, m):
        n = a.shape[0]
        t = _round_up(max(n, 1), m)
        if t == n:
            return a
        return np.concatenate(
            [a, np.repeat(a[-1:], t - n, axis=0)], axis=0)

    out = dict(pk)
    for k in ("read_codes_r", "eq_r", "uq_r", "log_off_r", "log_on_r",
              "bqt_r", "q95_r", "log10q_r"):
        out[k] = padrows(pk[k], 64)
    for k in ("hap_codes_h", "lpe_h", "lpn_h", "lpeV_h", "lpnV_h"):
        out[k] = padrows(pk[k], 8)
    B = pk["hap_idx"].shape[0]
    blk = 128
    blocks = _round_up(B, blk) // blk
    if blocks > 1:
        if blocks < 16:
            blocks = 1 << (blocks - 1).bit_length()
        else:
            blocks = _round_up(blocks, 16)
    Bp = blocks * blk
    for k in ("hap_idx", "read_idx", "hap_len", "read_len", "b_mid"):
        out[k] = padrows(pk[k], Bp)
    return out


@partial(jax.jit, static_argnames=("H_pad", "L_pad", "dtype_str"))
def _expand_compact(H_pad, L_pad, dtype_str,
                    read_codes_r, eq_r, uq_r, hap_codes_h, lpe_h, lpn_h,
                    lpeV_h, lpnV_h, hap_idx, read_idx, hap_len, b_mid,
                    log_off_r, log_on_r, hmq_consts, ins_consts):
    """Device-side expansion of a compact slab: gathers + prior/obs_mid
    assembly.  Every value is a host-computed number broadcast into the
    dense layout, so results are bit-identical to pack_pairs."""
    dt = np.dtype(dtype_str)
    S_half = H_pad + 2
    read_codes = read_codes_r[read_idx]
    eq = eq_r[read_idx]
    uq = uq_r[read_idx]
    hap_codes = hap_codes_h[hap_idx]
    lpe = lpe_h[hap_idx]
    lpn = lpn_h[hap_idx]
    lpeV = lpeV_h[hap_idx]
    lpnV = lpnV_h[hap_idx]
    B = read_idx.shape[0]

    # priors (dense layout of _expand_prior): lane 0 = off, 1..Hh = on,
    # H_pad+1 = -100, else NEGBIG — per ins-flag half
    lane = jnp.arange(S_half, dtype=jnp.int32)[None, :]
    hl = hap_len[:, None]
    lo_r = log_off_r[read_idx][:, None]
    on_r = log_on_r[read_idx][:, None]
    log_off_h, log_on_h = hmq_consts
    log_ins0, log_ins1 = ins_consts

    def prior_half(lo, on, log_ins):
        v0 = (lo + log_ins).astype(dt)
        von = (on + log_ins).astype(dt)
        v0 = jnp.broadcast_to(v0, (B, 1))
        von = jnp.broadcast_to(von, (B, S_half))
        row = jnp.where(lane == 0, v0,
                        jnp.where((lane >= 1) & (lane <= hl), von,
                                  jnp.where(lane == H_pad + 1,
                                            jnp.asarray(-100.0, dt),
                                            jnp.asarray(NEGBIG, dt))))
        return row

    prior_rmq = jnp.concatenate(
        [prior_half(lo_r, on_r, log_ins0),
         prior_half(lo_r, on_r, log_ins1)], axis=1)
    oh = jnp.full((B, 1), log_off_h)
    onh = jnp.full((B, 1), log_on_h)
    prior_hmq = jnp.concatenate(
        [prior_half(oh, onh, log_ins0),
         prior_half(oh, onh, log_ins1)], axis=1)

    # obs_mid (compute_obs_mid semantics, on device)
    bmc = b_mid[:, None]
    e = jnp.take_along_axis(eq, bmc, axis=1)
    u = jnp.take_along_axis(uq, bmc, axis=1)
    rb = jnp.take_along_axis(read_codes, bmc, axis=1)
    mismatch = (hap_codes != rb) & (hap_codes != ord("N"))
    on_o = jnp.where(mismatch, u, e)
    noins = jnp.concatenate(
        [e, on_o, jnp.broadcast_to(e, (B, 1)).astype(dt)], axis=1)
    obs_mid = jnp.concatenate(
        [noins, jnp.broadcast_to(e, (B, S_half)).astype(dt)], axis=1)
    return (read_codes, eq, uq, hap_codes, lpe, lpn, lpeV, lpnV,
            prior_rmq, prior_hmq, obs_mid)


def _compact_core(H_pad, L_pad, numT, dt_str, dp_impl, exact_ties,
                  read_codes_r, eq_r, uq_r, hap_codes_h, lpe_h, lpn_h,
                  lpeV_h, lpnV_h, hap_idx, read_idx, hap_len, read_len,
                  b_mid, log_off_r, log_on_r, hmq_consts, ins_consts,
                  scalars):
    """Compact-slab compute body: device-side expansion + DP + finish.
    Shared between the single-device path and the shard_map'ed mesh path
    (where it runs per shard on the local pair slice)."""
    (read_codes, eq, uq, hap_codes, lpe, lpn, lpeV, lpnV,
     prior_rmq, prior_hmq, obs_mid) = _expand_compact(
        H_pad, L_pad, dt_str, read_codes_r, eq_r, uq_r, hap_codes_h,
        lpe_h, lpn_h, lpeV_h, lpnV_h, hap_idx, read_idx, hap_len, b_mid,
        log_off_r, log_on_r, hmq_consts, ins_consts)
    dp = get_dp_impl(dp_impl)
    alpha_mid, beta_mid, btf, btb = dp(
        H_pad, L_pad, numT, hap_len, read_len, b_mid,
        read_codes, hap_codes, eq, uq, lpe, lpn, lpeV, lpnV, scalars)
    out = _finish(H_pad, L_pad, b_mid, alpha_mid, beta_mid, obs_mid,
                  prior_rmq, prior_hmq, btf, btb, exact_ties=exact_ties,
                  bt_codes=(dp_impl == "fused"), numT=numT,
                  hap_len=hap_len)
    if 2 * (H_pad + 2) < 2 ** 15:
        out = out[:-1] + (out[-1].astype(jnp.int16),)
    return out


def run_packed_compact(pk: dict, dp_impl: str = "xla",
                       exact_ties: bool = None):
    """run_packed for a compact slab: one small upload, device-side
    expansion, then the shared DP + finish."""
    if exact_ties is None:
        exact_ties = (dp_impl == "xla")
    dt = np.dtype(pk["eq_r"].dtype)
    return _compact_core(
        pk["H_pad"], pk["L_pad"], pk["numT"], dt.str, dp_impl, exact_ties,
        jnp.asarray(pk["read_codes_r"]), jnp.asarray(pk["eq_r"]),
        jnp.asarray(pk["uq_r"]), jnp.asarray(pk["hap_codes_h"]),
        jnp.asarray(pk["lpe_h"]), jnp.asarray(pk["lpn_h"]),
        jnp.asarray(pk["lpeV_h"]), jnp.asarray(pk["lpnV_h"]),
        jnp.asarray(pk["hap_idx"]), jnp.asarray(pk["read_idx"]),
        jnp.asarray(pk["hap_len"]), pk["read_len"],
        jnp.asarray(pk["b_mid"]),
        jnp.asarray(pk["log_off_r"]), jnp.asarray(pk["log_on_r"]),
        (pk["log_off_hmq"], pk["log_on_hmq"]),
        (pk["log_ins0"], pk["log_ins1"]), pk["scalars"])


@partial(jax.jit, static_argnames=("H_pad", "L_pad", "numT", "V", "W",
                                   "NH", "S", "NR", "exact_ties",
                                   "bt_codes", "do_call"))
def _finish_stats_call(H_pad, L_pad, numT, V, W, NH, S, NR, exact_ties,
                       bt_codes, do_call,
                       b_mid, alpha_mid, beta_mid, obs_mid, prior_rmq,
                       prior_hmq, btf, btb, hap_len, read_len, read_idx,
                       hap_idx, read_codes_r, hap_codes_h, bqt_r, q95_r,
                       log10q_r, v_left_h, v_right_h, v_isdel_h,
                       v_valid_h, index_map, nr_w, pair_pr,
                       max_mismatch):
    """Fused finish + per-pair stats + per-window calling folds: ONE
    device dispatch per slab after the DP kernel, with the results
    packed into six fetch arrays (every extra dispatch and every extra
    fetched leaf adds host latency)."""
    out = _finish(H_pad, L_pad, b_mid, alpha_mid, beta_mid, obs_mid,
                  prior_rmq, prior_hmq, btf, btb, exact_ties=exact_ties,
                  bt_codes=bt_codes, numT=numT, hap_len=hap_len)
    ll, off_hap, off_hap_hmq, ll_off, ll_on, map_state = out
    stats = _pair_stats(H_pad, L_pad, V, map_state, read_len, hap_len,
                        read_idx, hap_idx, read_codes_r, hap_codes_h,
                        bqt_r, q95_r, log10q_r, v_left_h, v_right_h,
                        v_isdel_h, v_valid_h, off_hap_hmq, max_mismatch)
    (fb, lb, n_bqt, n_mm_bqt, m_log_bq, n_mm_left, n_mm_right, num_mm,
     has_event, any_mism, n_ind, cov_ok) = stats
    if do_call:
        from ..infer.device_call import _window_call
        base, site = _window_call(W, NH, S, NR, ll, index_map, nr_w,
                                  pair_pr)
    else:
        # folds are computed on host (exp/log rounding parity — see
        # infer/device_call.host_window_folds); ship empty stubs
        base = jnp.zeros((0,), pair_pr.dtype)
        site = jnp.zeros((0,), pair_pr.dtype)
    f_plane = jnp.stack([ll, ll_off, ll_on], axis=1)
    # Fetch diet: the count stats all fit int16 (bounded by L_pad <=
    # 512), and the flag plane bitpacks 8x; _finish_slab_stats reverses
    # both exactly.
    i_plane = jnp.stack([fb, lb, n_bqt, n_mm_bqt, n_mm_left, n_mm_right,
                         num_mm, n_ind], axis=1).astype(jnp.int16)
    b_plane = jnp.packbits(
        jnp.concatenate(
            [jnp.stack([off_hap, off_hap_hmq, has_event, any_mism],
                       axis=1), cov_ok], axis=1).astype(jnp.uint8),
        axis=1)
    return f_plane, m_log_bq, i_plane, b_plane, base, site


_FUSED_CACHE = {}


def run_slab_stats_fused(pk: dict, dp_impl: str, vtab: dict,
                         callmeta: dict, max_mismatch: int,
                         exact_ties: bool = None, do_call: bool = True):
    """Single-device production slab program with device-side calling:
    expand + DP + finish + stats + window folds as ONE jitted dispatch.

    One dispatch matters twice over: each dispatch costs host time, and
    — decisive for pipelining — the multi-GB backpointer tensors never
    appear as dispatch outputs, so their device memory lives only inside
    one program execution and the engine can keep a whole batch of slabs
    in flight (the 3-dispatch structure allocated bt buffers at enqueue,
    capping the pipeline at ~4 slabs)."""
    if exact_ties is None:
        exact_ties = (dp_impl == "xla")
    dt = np.dtype(pk["eq_r"].dtype)
    cm = callmeta
    V = vtab["v_left_h"].shape[1]
    hmq_consts = (pk["log_off_hmq"], pk["log_on_hmq"])
    ins_consts = (pk["log_ins0"], pk["log_ins1"])
    scalars_np = np.asarray(pk["scalars"])
    key = (pk["H_pad"], pk["L_pad"], pk["numT"], dt.str, dp_impl,
           exact_ties, do_call, V, cm["W"], cm["NH"], cm["S"], cm["NR"],
           hmq_consts, ins_consts, tuple(float(x) for x in scalars_np))
    fn = _FUSED_CACHE.get(key)
    if fn is None:
        H_pad, L_pad, numT = pk["H_pad"], pk["L_pad"], pk["numT"]
        W, NH, S, NR = cm["W"], cm["NH"], cm["S"], cm["NR"]
        bt_codes = dp_impl == "fused"

        @jax.jit
        def fn(read_codes_r, eq_r, uq_r, hap_codes_h, lpe_h, lpn_h,
               lpeV_h, lpnV_h, hap_idx, read_idx, hap_len, read_len,
               b_mid, log_off_r, log_on_r, bqt_r, q95_r, log10q_r,
               v_left_h, v_right_h, v_isdel_h, v_valid_h, index_map,
               nr_w, pair_pr, scalars, max_mm):
            (read_codes, eq, uq, hap_codes, lpe, lpn, lpeV, lpnV,
             prior_rmq, prior_hmq, obs_mid) = _expand_compact(
                H_pad, L_pad, dt.str, read_codes_r, eq_r, uq_r,
                hap_codes_h, lpe_h, lpn_h, lpeV_h, lpnV_h, hap_idx,
                read_idx, hap_len, b_mid, log_off_r, log_on_r,
                hmq_consts, ins_consts)
            dp = get_dp_impl(dp_impl)
            alpha_mid, beta_mid, btf, btb = dp(
                H_pad, L_pad, numT, hap_len, read_len, b_mid,
                read_codes, hap_codes, eq, uq, lpe, lpn, lpeV, lpnV,
                scalars)
            return _finish_stats_call(
                H_pad, L_pad, numT, V, W, NH, S, NR, exact_ties,
                bt_codes, do_call, b_mid, alpha_mid, beta_mid, obs_mid,
                prior_rmq, prior_hmq, btf, btb, hap_len, read_len,
                read_idx, hap_idx, read_codes_r, hap_codes_h, bqt_r,
                q95_r, log10q_r, v_left_h, v_right_h, v_isdel_h,
                v_valid_h, index_map, nr_w, pair_pr, max_mm)

        _FUSED_CACHE[key] = fn
    return fn(pk["read_codes_r"], pk["eq_r"], pk["uq_r"],
              pk["hap_codes_h"], pk["lpe_h"], pk["lpn_h"], pk["lpeV_h"],
              pk["lpnV_h"], pk["hap_idx"], pk["read_idx"], pk["hap_len"],
              pk["read_len"], pk["b_mid"], pk["log_off_r"],
              pk["log_on_r"], pk["bqt_r"], pk["q95_r"], pk["log10q_r"],
              vtab["v_left_h"], vtab["v_right_h"], vtab["v_isdel_h"],
              vtab["v_valid_h"], cm["index_map"], cm["nr_w"],
              cm["pair_pr"], pk["scalars"], np.int32(max_mismatch))


def run_packed_compact_stats(pk: dict, dp_impl: str, vtab: dict,
                             max_mismatch: int, exact_ties: bool = None,
                             mesh=None, want_map_state: bool = False):
    """Compact slab DP + finish + DEVICE per-pair stats: the production
    calling path.  Returns a dict of device arrays (all async); without
    want_map_state the (B, L_pad) planes never leave the device.

    vtab: per-hap variant flank tables aligned with the (padded) compact
    hap tables — v_left_h/v_right_h (rows, V) int32, v_isdel_h/v_valid_h
    (rows, V) bool."""
    if exact_ties is None:
        exact_ties = (dp_impl == "xla")
    if mesh is not None:
        out = run_packed_compact_sharded(pk, dp_impl, mesh,
                                         exact_ties=exact_ties)
    else:
        out = run_packed_compact(pk, dp_impl, exact_ties=exact_ties)
    V = vtab["v_left_h"].shape[1]
    stats = _pair_stats(
        pk["H_pad"], pk["L_pad"], V, out[5],
        jnp.asarray(pk["read_len"]), jnp.asarray(pk["hap_len"]),
        jnp.asarray(pk["read_idx"]), jnp.asarray(pk["hap_idx"]),
        jnp.asarray(pk["read_codes_r"]), jnp.asarray(pk["hap_codes_h"]),
        jnp.asarray(pk["bqt_r"]), jnp.asarray(pk["q95_r"]),
        jnp.asarray(pk["log10q_r"]),
        jnp.asarray(vtab["v_left_h"]), jnp.asarray(vtab["v_right_h"]),
        jnp.asarray(vtab["v_isdel_h"]), jnp.asarray(vtab["v_valid_h"]),
        out[2], jnp.asarray(np.int32(max_mismatch)))
    res = dict(ll=out[0], off_hap=out[1], off_hap_hmq=out[2],
               ll_off=out[3], ll_on=out[4],
               fb=stats[0], lb=stats[1], n_bqt=stats[2], n_mm_bqt=stats[3],
               m_log_bq=stats[4], n_mm_left=stats[5], n_mm_right=stats[6],
               num_mm=stats[7], has_event=stats[8], any_mism=stats[9],
               n_ind=stats[10], cov_ok=stats[11])
    if want_map_state:
        res["map_state"] = out[5]
    return res


_SHARDED_CACHE = {}


def run_packed_compact_sharded(pk: dict, dp_impl: str, mesh,
                               exact_ties: bool = None):
    """run_packed_compact under a dp x rp jax.sharding.Mesh: the slab's
    pair axis is sharded over every mesh device (both axes flattened —
    pairs are embarrassingly parallel and each shard runs the full
    production expand/DP/finish); the small per-read/per-hap tables are
    replicated.  The pair axis is padded to a device multiple with clones
    of the last real row (as in
    pad_compact) and every output is sliced back, so results are
    bit-identical to the single-device path
    (tests/test_parallel.py::test_engine_sharded_step_bit_equal)."""
    from jax.sharding import PartitionSpec as P
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from jax.experimental.shard_map import shard_map

    if exact_ties is None:
        exact_ties = (dp_impl == "xla")
    n_dev = mesh.devices.size
    B = pk["hap_idx"].shape[0]
    Bp = _round_up(B, n_dev)

    def padpairs(a):
        if Bp == a.shape[0]:
            return a
        return np.concatenate([a, np.repeat(a[-1:], Bp - a.shape[0],
                                            axis=0)], axis=0)

    dt = np.dtype(pk["eq_r"].dtype)
    tables = (jnp.asarray(pk["read_codes_r"]), jnp.asarray(pk["eq_r"]),
              jnp.asarray(pk["uq_r"]), jnp.asarray(pk["hap_codes_h"]),
              jnp.asarray(pk["lpe_h"]), jnp.asarray(pk["lpn_h"]),
              jnp.asarray(pk["lpeV_h"]), jnp.asarray(pk["lpnV_h"]),
              jnp.asarray(pk["log_off_r"]), jnp.asarray(pk["log_on_r"]))
    pairs = tuple(jnp.asarray(padpairs(np.asarray(pk[k])))
                  for k in ("hap_idx", "read_idx", "hap_len", "read_len",
                            "b_mid"))
    scalars_np = np.asarray(pk["scalars"])
    key = (id(mesh), pk["H_pad"], pk["L_pad"], pk["numT"], dt.str, dp_impl,
           exact_ties, pk["log_off_hmq"], pk["log_on_hmq"],
           pk["log_ins0"], pk["log_ins1"],
           tuple(float(x) for x in scalars_np))
    fn = _SHARDED_CACHE.get(key)
    if fn is None:
        hmq_consts = (pk["log_off_hmq"], pk["log_on_hmq"])
        ins_consts = (pk["log_ins0"], pk["log_ins1"])
        # scalars stay a runtime operand, as on the single device: baking
        # them lets XLA constant-fold (y-1)*logpInsgIns where the
        # single-device executable FMA-contracts it, a one-ulp f32
        # divergence.

        def body(tables_, pairs_, scalars_arg):
            (rc_r, eq_r, uq_r, hc_h, lpe_h, lpn_h, lpeV_h, lpnV_h,
             lor, lonr) = tables_
            hap_idx, read_idx, hap_len, read_len, b_mid = pairs_
            return _compact_core(
                pk["H_pad"], pk["L_pad"], pk["numT"], dt.str, dp_impl,
                exact_ties, rc_r, eq_r, uq_r, hc_h, lpe_h, lpn_h, lpeV_h,
                lpnV_h, hap_idx, read_idx, hap_len, read_len, b_mid,
                lor, lonr, hmq_consts, ins_consts, scalars_arg)

        axes = tuple(mesh.axis_names)
        pair_spec = P(axes)
        sm = shard_map(
            body, mesh=mesh,
            in_specs=((P(),) * 10, (pair_spec,) * 5, P()),
            out_specs=(pair_spec,) * 6,
            check_rep=False)
        fn = jax.jit(sm)
        _SHARDED_CACHE[key] = fn
    out = fn(tables, pairs, jnp.asarray(scalars_np))
    if Bp != B:
        out = tuple(o[:B] for o in out)
    return out


def expand_compact_host(pk: dict) -> dict:
    """Host-side (numpy) expansion of a compact pk into the dense layout
    — for parity tests and for consumers that need the dense per-pair
    code arrays (decode_map_alignments)."""
    out = dict(H_pad=pk["H_pad"], L_pad=pk["L_pad"], numT=pk["numT"],
               nh=pk["nh"], nr=pk["nr"], scalars=pk["scalars"],
               hap_len=pk["hap_len"], read_len=pk["read_len"],
               b_mid=pk["b_mid"])
    hi, ri = pk["hap_idx"], pk["read_idx"]
    out["read_codes"] = pk["read_codes_r"][ri]
    out["eq"] = pk["eq_r"][ri]
    out["uq"] = pk["uq_r"][ri]
    out["hap_codes"] = pk["hap_codes_h"][hi]
    out["lpe"] = pk["lpe_h"][hi]
    out["lpn"] = pk["lpn_h"][hi]
    out["lpeV"] = pk["lpeV_h"][hi]
    out["lpnV"] = pk["lpnV_h"][hi]
    dt = pk["eq_r"].dtype
    S_half = pk["H_pad"] + 2
    B = ri.shape[0]
    lane = np.arange(S_half)[None, :]
    hl = pk["hap_len"][:, None]

    def prior_half(lo, on, log_ins):
        v0 = np.asarray(lo + log_ins, dt)
        von = np.asarray(on + log_ins, dt)
        row = np.where(lane == 0, np.broadcast_to(v0, (B, S_half)),
                       np.where((lane >= 1) & (lane <= hl),
                                np.broadcast_to(von, (B, S_half)),
                                np.where(lane == pk["H_pad"] + 1,
                                         dt.type(-100.0), dt.type(NEGBIG))))
        return row.astype(dt)

    lo_r = pk["log_off_r"][ri][:, None]
    on_r = pk["log_on_r"][ri][:, None]
    out["prior_rmq"] = np.concatenate(
        [prior_half(lo_r, on_r, pk["log_ins0"]),
         prior_half(lo_r, on_r, pk["log_ins1"])], axis=1)
    oh = np.full((B, 1), pk["log_off_hmq"])
    onh = np.full((B, 1), pk["log_on_hmq"])
    out["prior_hmq"] = np.concatenate(
        [prior_half(oh, onh, pk["log_ins0"]),
         prior_half(oh, onh, pk["log_ins1"])], axis=1)
    return out


def _pack_pairs_ref(haps: List[Haplotype], reads: List[Read], hap_start: int,
                    p: ObservationModelParameters, dtype=np.float64,
                    bucket: int = 16, H_pad: int = None, L_pad: int = None) -> dict:
    """Per-pair (slow) packing loop — retained as the differential oracle
    for the vectorized pack_pairs (tests/test_pack_vectorized.py)."""
    nh, nr = len(haps), len(reads)
    H_max = max(h.size() for h in haps)
    L_max = max(r.size() for r in reads)
    if H_pad is None:
        H_pad = _round_up(H_max, bucket)
    if L_pad is None:
        L_pad = _round_up(max(L_max, 2), bucket)
    numT = p.max_length_del + 2
    S_half = H_pad + 2
    S = 2 * S_half
    B = nh * nr
    dt = dtype

    hap_len = np.zeros(B, np.int32)
    read_len = np.zeros(B, np.int32)
    b_mid = np.zeros(B, np.int32)
    read_codes = np.zeros((B, L_pad), np.uint8)
    hap_codes = np.zeros((B, H_pad), np.uint8)
    eq = np.zeros((B, L_pad), dt)
    uq = np.zeros((B, L_pad), dt)
    lpe = np.full((B, S_half), math.log(1e-5), dt)
    lpn = np.full((B, S_half), math.log(1 - 1e-5), dt)
    prior_rmq = np.zeros((B, S), dt)
    prior_hmq = np.zeros((B, S), dt)

    hap_arrs = []
    for h in haps:
        e_, n_ = hp_log_prob_error(h.seq)
        hap_arrs.append((e_, n_))
    tr_dummy = _Trans(p, haps[0].seq)

    for hi, hap in enumerate(haps):
        Hh = hap.size()
        if p.max_length_del > Hh:
            raise ValueError("hapSize error.")
        hseq = np.frombuffer(hap.seq.encode(), np.uint8)
        e_, n_ = hap_arrs[hi]
        for ri, r in enumerate(reads):
            i = hi * nr + ri
            hap_len[i] = Hh
            L = r.size()
            read_len[i] = L
            bm = compute_b_mid(r, hap_start, Hh, p.b_mid)
            b_mid[i] = bm
            read_codes[i, :L] = np.frombuffer(r.seq.encode(), np.uint8)
            hap_codes[i, :Hh] = hseq
            pr = np.asarray(r.qual, np.float64) * (1.0 - p.p_mut)
            eq[i, :L] = np.log(0.25 + 0.75 * pr)
            uq[i, :L] = np.log(0.75 + 1e-10 - 0.75 * pr)
            lpe[i, :Hh + 2] = e_
            lpn[i, :Hh + 2] = n_
            pr_r = compute_b_mid_prior(tr_dummy, r, hap_start, Hh, p,
                                       r.map_qual, bm)
            pr_h = compute_b_mid_prior(tr_dummy, r, hap_start, Hh, p,
                                       1.0 - 1e-10, bm)
            prior_rmq[i] = _expand_prior(pr_r, Hh, H_pad)
            prior_hmq[i] = _expand_prior(pr_h, Hh, H_pad)

    # V-arrays: lpe/lpn with indices beyond Hh clamped to the per-hap RO
    lpeV = np.zeros((B, S_half + numT), dt)
    lpnV = np.zeros((B, S_half + numT), dt)
    for i in range(B):
        Hh = hap_len[i]
        ROi = Hh + 1
        core_e = np.full(S_half + numT, lpe[i, ROi])
        core_n = np.full(S_half + numT, lpn[i, ROi])
        core_e[:Hh + 1] = lpe[i, :Hh + 1]
        core_n[:Hh + 1] = lpn[i, :Hh + 1]
        lpeV[i] = core_e
        lpnV[i] = core_n
        if ROi != H_pad + 1:
            lpe[i, H_pad + 1] = lpe[i, ROi]
            lpn[i, H_pad + 1] = lpn[i, ROi]

    scalars = np.array([math.log(1.0 - p.p_first_g_lo),
                        math.log(p.p_first_g_lo),
                        -0.5,
                        math.log(1.0 - math.exp(-0.5)),
                        math.log(1.0 - p.p_error)], dt)
    return dict(H_pad=H_pad, L_pad=L_pad, numT=numT, nh=nh, nr=nr,
                hap_len=hap_len, read_len=read_len, b_mid=b_mid,
                read_codes=read_codes, hap_codes=hap_codes, eq=eq, uq=uq,
                lpe=lpe, lpn=lpn, lpeV=lpeV, lpnV=lpnV,
                prior_rmq=prior_rmq, prior_hmq=prior_hmq, scalars=scalars)


def pack_pairs(haps: List[Haplotype], reads: List[Read], hap_start: int,
               p: ObservationModelParameters, dtype=np.float64,
               bucket: int = 16, H_pad: int = None, L_pad: int = None) -> dict:
    """Pack a window's (haps x reads) pairs into the fixed-layout arrays
    consumed by the DP kernels.  Vectorized (per-read and per-hap arrays
    computed once, broadcast over the cross product): ~50x faster than the
    per-pair loop (_pack_pairs_ref), byte-identical outputs
    (tests/test_pack_vectorized.py).  Host packing is on the critical path
    now that device time is ~10 ms per slab (PERF_NOTES.md)."""
    nh, nr = len(haps), len(reads)
    H_max = max(h.size() for h in haps)
    L_max = max(r.size() for r in reads)
    if H_pad is None:
        H_pad = _round_up(H_max, bucket)
    if L_pad is None:
        L_pad = _round_up(max(L_max, 2), bucket)
    numT = p.max_length_del + 2
    S_half = H_pad + 2
    S = 2 * S_half
    B = nh * nr
    dt = dtype

    # ---- per-read arrays (computed once, tiled over haps) ----
    read_len_r = np.fromiter((r.size() for r in reads), np.int32, nr)
    read_codes_r = np.zeros((nr, L_pad), np.uint8)
    qual_r = np.zeros((nr, L_pad), np.float64)
    for ri, r in enumerate(reads):
        L = read_len_r[ri]
        read_codes_r[ri, :L] = np.frombuffer(r.seq.encode(), np.uint8)
        qual_r[ri, :L] = r.qual
    col = np.arange(L_pad)[None, :]
    in_read = col < read_len_r[:, None]
    pr = qual_r * (1.0 - p.p_mut)
    eq_r = np.where(in_read, np.log(0.25 + 0.75 * pr), 0.0).astype(dt)
    uq_r = np.where(in_read, np.log(0.75 + 1e-10 - 0.75 * pr), 0.0).astype(dt)
    map_qual_r = np.fromiter((r.map_qual for r in reads), np.float64, nr)
    unmapped_r = np.fromiter((r.is_unmapped for r in reads), bool, nr)
    psf_r = np.fromiter((read.pos_stat_first for read in reads),
                        np.float64, nr)

    # vectorized compute_b_mid (ObservationModelFB.cpp:50-99): truncation
    # toward zero matches C++ int casts for the non-negative coordinates
    def b_mid_vec(Hh: int) -> np.ndarray:
        m = psf_r.astype(np.int64)
        read_end = m + read_len_r - 1
        hap_end = hap_start + Hh
        half = read_len_r // 2
        ol_start = np.maximum(hap_start, m)
        ol_end = np.where(hap_end > read_end, read_end, hap_end)
        mid = (ol_end - ol_start) // 2 + ol_start
        bm = np.where(unmapped_r | (m > hap_end) | (read_end < hap_start),
                      half, mid - m)
        if p.b_mid != -1:
            bm = np.full_like(bm, p.b_mid)
        return np.clip(bm, 0, read_len_r - 1).astype(np.int32)

    # vectorized computeBMidPrior (ObservationModelFB.cpp:268-305) over
    # reads, for one haplotype length Hh.  pinsert handling (the
    # insert-size positional prior for unmapped-mate realignment) is a
    # per-read fallback — rare, library mode only.
    tr_dummy = _Trans(p, haps[0].seq)
    log_ins1 = tr_dummy.logpInsgNoIns
    log_ins0 = math.log(1.0 - math.exp(tr_dummy.logpInsgNoIns))

    def prior_vec(Hh: int, bm: np.ndarray, map_qual: np.ndarray
                  ) -> np.ndarray:
        mq = 1.0 - map_qual
        capped = -10.0 * np.log10(mq) > p.map_qual_threshold
        mq = np.where(capped, 10.0 ** (-p.map_qual_threshold / 10.0), mq)
        log_off = np.log(mq)[:, None]
        log_on = np.log(1.0 - mq)[:, None]
        numS = Hh + 2
        out = np.zeros((nr, 2 * numS))
        need_pinsert = (p.map_unmapped_reads and
                        any(r.is_paired and not r.mate_is_unmapped
                            and r.mate_len != -1 and r.same_tid_as_mate
                            for r in reads))
        pins = np.zeros((nr, numS))
        if need_pinsert:
            x = np.arange(1, Hh + 1)
            for ri, r in enumerate(reads):
                if (r.is_paired and not r.mate_is_unmapped
                        and r.mate_len != -1 and r.same_tid_as_mate):
                    lib = r.get_library()
                    if r.mate_is_reverse:
                        d = np.abs(hap_start + x - bm[ri]
                                   - (r.mate_pos + r.mate_len))
                    else:
                        d = np.abs(hap_start + x + r.size() - bm[ri]
                                   - r.mate_pos)
                    pins[ri, 1:Hh + 1] = np.log(lib.get_prob_vec(d))
                    pins[ri, 0] = math.log(lib.ninetyfifth_pct_prob)
        for i, log_ins in enumerate((log_ins0, log_ins1)):
            blk = out[:, i * numS:(i + 1) * numS]
            blk[:, 0] = log_off[:, 0] + log_ins + pins[:, 0]
            blk[:, 1:Hh + 1] = pins[:, 1:Hh + 1] + log_on + log_ins
            blk[:, Hh + 1] = -100.0
        return out

    # ---- per-hap arrays, broadcast into the (hap-major) pair blocks ----
    hap_len = np.zeros(B, np.int32)
    read_len = np.tile(read_len_r, nh)
    b_mid = np.zeros(B, np.int32)
    read_codes = np.tile(read_codes_r, (nh, 1))
    hap_codes = np.zeros((B, H_pad), np.uint8)
    eq = np.tile(eq_r, (nh, 1))
    uq = np.tile(uq_r, (nh, 1))
    lpe = np.full((B, S_half), math.log(1e-5), dt)
    lpn = np.full((B, S_half), math.log(1 - 1e-5), dt)
    lpeV = np.zeros((B, S_half + numT), dt)
    lpnV = np.zeros((B, S_half + numT), dt)
    prior_rmq = np.full((B, S), NEGBIG, dt)
    prior_hmq = np.full((B, S), NEGBIG, dt)
    hmq_r = np.full(nr, 1.0 - 1e-10)

    for hi, hap in enumerate(haps):
        Hh = hap.size()
        if p.max_length_del > Hh:
            raise ValueError("hapSize error.")
        sl = slice(hi * nr, (hi + 1) * nr)
        hap_len[sl] = Hh
        hseq = np.frombuffer(hap.seq.encode(), np.uint8)
        hap_codes[sl, :Hh] = hseq[None, :]
        e_, n_ = hp_log_prob_error(hap.seq)
        lpe[sl, :Hh + 2] = np.asarray(e_, dt)[None, :]
        lpn[sl, :Hh + 2] = np.asarray(n_, dt)[None, :]
        ROi = Hh + 1
        if ROi != H_pad + 1:
            lpe[sl, H_pad + 1] = lpe[hi * nr, ROi]
            lpn[sl, H_pad + 1] = lpn[hi * nr, ROi]
        # V-arrays: per-hap constant rows
        core_e = np.full(S_half + numT, e_[ROi])
        core_n = np.full(S_half + numT, n_[ROi])
        core_e[:Hh + 1] = e_[:Hh + 1]
        core_n[:Hh + 1] = n_[:Hh + 1]
        lpeV[sl] = core_e[None, :]
        lpnV[sl] = core_n[None, :]
        bm = b_mid_vec(Hh)
        b_mid[sl] = bm
        pr_r = prior_vec(Hh, bm, map_qual_r)
        pr_h = prior_vec(Hh, bm, hmq_r)
        # _expand_prior, vectorized: per-half [0..Hh] block + RO slot
        numS = Hh + 2
        for half in range(2):
            prior_rmq[sl, half * S_half:half * S_half + Hh + 1] = (
                pr_r[:, half * numS:half * numS + Hh + 1])
            prior_rmq[sl, half * S_half + H_pad + 1] = (
                pr_r[:, half * numS + Hh + 1])
            prior_hmq[sl, half * S_half:half * S_half + Hh + 1] = (
                pr_h[:, half * numS:half * numS + Hh + 1])
            prior_hmq[sl, half * S_half + H_pad + 1] = (
                pr_h[:, half * numS + Hh + 1])

    scalars = np.array([math.log(1.0 - p.p_first_g_lo),
                        math.log(p.p_first_g_lo),
                        -0.5,
                        math.log(1.0 - math.exp(-0.5)),
                        math.log(1.0 - p.p_error)], dt)
    return dict(H_pad=H_pad, L_pad=L_pad, numT=numT, nh=nh, nr=nr,
                hap_len=hap_len, read_len=read_len, b_mid=b_mid,
                read_codes=read_codes, hap_codes=hap_codes, eq=eq, uq=uq,
                lpe=lpe, lpn=lpn, lpeV=lpeV, lpnV=lpnV,
                prior_rmq=prior_rmq, prior_hmq=prior_hmq, scalars=scalars)


class BatchedPairHMM:
    """Window-level driver: packs haps/reads, runs the kernels (bucketed
    by padded shapes), converts back to MLAlignment."""

    def __init__(self, params: ObservationModelParameters,
                 dtype=np.float64, bucket: int = 16, dp_impl: str = "xla"):
        self.params = params
        self.dtype = dtype
        self.bucket = bucket
        self.dp_impl = dp_impl

    def compute(self, haps: List[Haplotype], reads: List[Read],
                hap_start: int) -> List[List[MLAlignment]]:
        p = self.params
        nh, nr = len(haps), len(reads)
        if nh == 0 or nr == 0:
            return [[]]
        pk = pack_pairs(haps, reads, hap_start, p, self.dtype, self.bucket)
        H_pad = pk["H_pad"]

        (ll, off_hap, off_hap_hmq, ll_off, ll_on, map_state) = run_packed(
            pk, self.dp_impl)
        ll = np.asarray(ll)
        off_hap = np.asarray(off_hap)
        off_hap_hmq = np.asarray(off_hap_hmq)
        ll_off = np.asarray(ll_off)
        ll_on = np.asarray(ll_on)
        map_state = np.asarray(map_state)

        return decode_liks_view(haps, reads, pk, ll, off_hap,
                                off_hap_hmq, ll_off, ll_on, map_state, p)


class LiksView:
    """Array-backed liks matrix (nh x nr) over the device outputs.

    Callers that understand it (infer/, engine/) consume whole-matrix
    arrays (``ll2d``, ``off_hap2d``, ...) directly; ``liks[h][r]`` still
    yields a full MLAlignment, materialized lazily and cached, so every
    per-pair consumer (realigned-BAM CIGARs, --opl dumps, oracle-parity
    tests) keeps working unchanged.  The materialization body is
    field-for-field the per-base-loop decode (tests/test_report_fast.py);
    arrays-vs-materialized equivalence is asserted in
    tests/test_liks_view.py."""

    def __init__(self, haps: List[Haplotype], reads: List[Read],
                 pk: dict, ll, off_hap, off_hap_hmq, ll_off, ll_on,
                 map_state, p: ObservationModelParameters):
        self.haps = haps
        self.reads = reads
        self.p = p
        nh, nr = len(haps), len(reads)
        self.nh = nh
        self.nr = nr
        H_pad = pk["H_pad"]
        L_pad = pk["L_pad"]
        self.H_pad = H_pad
        self.L_pad = L_pad
        self.read_len = pk["read_len"]
        self._hap_len = pk["hap_len"]
        self._ms = np.asarray(map_state)
        self._pk_read_codes = pk["read_codes"]
        self._pk_hap_codes = pk["hap_codes"]

        self.ll = np.asarray(ll, np.float64)
        self.off_hap = np.asarray(off_hap, bool)
        self.off_hap_hmq = np.asarray(off_hap_hmq, bool)
        self.ll_off = np.asarray(ll_off, np.float64)
        self.ll_on = np.asarray(ll_on, np.float64)
        # lazily-derived (B, L_pad) matrices; the native decode fills
        # xs/hpos directly and only per-pair consumers (events, SNP
        # reports) ever force the rest
        self._ins_all = None
        self._del_ev = None
        self._mism = None
        self._noins_on = None

        qual_b = np.zeros((nr, L_pad))
        for ri, r in enumerate(reads):
            qual_b[ri, :r.size()] = r.qual
        with np.errstate(divide="ignore"):
            log10q = np.log10(np.maximum(1.0 - qual_b, 1e-300))
        self._qual_r = qual_b  # (nr, L_pad); pair i uses row i % nr

        from .decode_native import native_lib as _dec_lib
        if _dec_lib() is not None:
            self._init_native(_dec_lib(), qual_b, log10q)
        else:
            self._init_numpy(qual_b, log10q)
        # indel events are enumerated lazily per pair (has_event flags
        # which pairs carry any; a pair has num_indels == 0 iff not
        # has_event, which is what the filter/selection logic needs)
        self._events = {}
        self._nind_rows = {}
        self._cache = {}

    def _init_native(self, lib, qual_b: np.ndarray, log10q: np.ndarray):
        """One C pass (native/decode.cpp) producing the same arrays as
        _init_numpy; equality asserted in tests/test_liks_view.py."""
        B = self.nh * self.nr
        L_pad, H_pad = self.L_pad, self.H_pad
        ms = np.ascontiguousarray(self._ms, np.int16)
        read_len = np.ascontiguousarray(self.read_len, np.int32)
        hap_len = np.ascontiguousarray(self._hap_len, np.int32)
        rc = np.ascontiguousarray(self._pk_read_codes, np.uint8)
        hc = np.ascontiguousarray(self._pk_hap_codes, np.uint8)
        xs = np.empty((B, L_pad), np.int32)
        hpos = np.empty((B, L_pad), np.int32)
        del_ev = np.empty((B, L_pad - 1), np.uint8)
        i64 = lambda: np.empty(B, np.int64)
        n_bqt, n_mm_bqt, n_mm_left, n_mm_right, num_mm, fb, lb = (
            i64(), i64(), i64(), i64(), i64(), i64(), i64())
        m_log_bq = np.empty(B, np.float64)
        has_event = np.empty(B, np.uint8)
        any_mism = np.empty(B, np.uint8)
        lib.ddec_stats(B, L_pad, H_pad, self.nr, ms, read_len, hap_len,
                       rc, hc, np.ascontiguousarray(qual_b),
                       np.ascontiguousarray(log10q),
                       float(self.p.check_base_qual_threshold),
                       xs, hpos, del_ev, n_bqt, n_mm_bqt, n_mm_left,
                       n_mm_right, num_mm, m_log_bq, fb, lb, has_event,
                       any_mism)
        self._del_ev = del_ev.view(bool)
        self.xs = xs
        self.hpos_all = hpos
        self.fb = fb
        self.lb = lb
        self.n_bqt = n_bqt
        self.n_mm_bqt = n_mm_bqt
        self.n_mm_left = n_mm_left
        self.n_mm_right = n_mm_right
        self.num_mm = num_mm
        self.m_log_bq = m_log_bq
        self.has_event = has_event.astype(bool)
        self.any_mism = any_mism.astype(bool)

    def _init_numpy(self, qual_b: np.ndarray, log10q: np.ndarray):
        from ..model import HPOS_LO, HPOS_RO

        nh, nr = self.nh, self.nr
        H_pad, L_pad = self.H_pad, self.L_pad
        B = nh * nr
        S_half_f = H_pad + 2
        hap_len = self._hap_len
        read_len = self.read_len
        map_state = self._ms
        ins_all = map_state >= S_half_f
        x_all = map_state % S_half_f
        ROh_all = (hap_len + 1)[:, None]
        xs = np.where(x_all == H_pad + 1, ROh_all, x_all)
        col = np.arange(L_pad)[None, :]
        validc = col < read_len[:, None]
        on = (xs >= 1) & (xs <= hap_len[:, None]) & validc
        ins_ev = ins_all & on
        noins_on = on & ~ins_all
        del_ev = (noins_on[:, :-1] & ~ins_all[:, 1:]
                  & (col[:, 1:] < read_len[:, None])
                  & (xs[:, 1:] - xs[:, :-1] > 1))
        has_event = ins_ev.any(axis=1) | del_ev.any(axis=1)

        hpos_all = np.where(noins_on, xs - 1,
                            np.where(xs == 0, HPOS_LO, HPOS_RO))
        big = np.iinfo(np.int32).max
        fb_all = np.where(noins_on, xs - 1, big).min(axis=1)
        fb_all = np.where(fb_all == big, -1, fb_all)
        lb_all = np.where(noins_on, xs - 1, -1).max(axis=1)

        qual_t = np.tile(qual_b, (nh, 1))
        bqt = noins_on & (qual_t > self.p.check_base_qual_threshold)
        hc = np.take_along_axis(self._pk_hap_codes,
                                np.clip(xs - 1, 0, H_pad - 1), axis=1)
        mism = noins_on & (self._pk_read_codes != hc)
        n_bqt_all = bqt.sum(axis=1)
        n_mm_bqt_all = (mism & bqt).sum(axis=1)
        n_mm_left_all = (mism & (col < 6)).sum(axis=1)
        n_mm_right_all = (mism & (col > read_len[:, None] - 6)).sum(axis=1)
        num_mm_all = (mism & (qual_t > 0.95)).sum(axis=1)
        # sequential (loop-order) float accumulation for bit-parity with
        # the per-base loop: column-at-a-time adds, masked terms as +0.0
        log10q_t = np.where(bqt, np.tile(log10q, (nh, 1)), 0.0)
        mlogbq_all = np.zeros(B)
        for b in range(L_pad):
            mlogbq_all = mlogbq_all + log10q_t[:, b]

        self.xs = xs
        self._ins_all = ins_all
        self._del_ev = del_ev
        self._noins_on = noins_on
        self.has_event = has_event
        self.any_mism = mism.any(axis=1)
        self._mism = mism
        self.hpos_all = hpos_all
        self.fb = fb_all
        self.lb = lb_all
        self.n_bqt = n_bqt_all
        self.n_mm_bqt = n_mm_bqt_all
        self.n_mm_left = n_mm_left_all
        self.n_mm_right = n_mm_right_all
        self.num_mm = num_mm_all
        self.m_log_bq = mlogbq_all

    # --- lazily-derived (B, L_pad) matrices (native init skips them) ---

    @property
    def ins_all(self):
        if self._ins_all is None:
            self._ins_all = self._ms >= (self.H_pad + 2)
        return self._ins_all

    @property
    def noins_on(self):
        if self._noins_on is None:
            col = np.arange(self.L_pad)[None, :]
            validc = col < self.read_len[:, None]
            xs = self.xs
            on = (xs >= 1) & (xs <= self._hap_len[:, None]) & validc
            self._noins_on = on & ~self.ins_all
        return self._noins_on

    @property
    def del_ev(self):
        if self._del_ev is None:
            col = np.arange(self.L_pad)[None, :]
            xs = self.xs
            self._del_ev = (self.noins_on[:, :-1] & ~self.ins_all[:, 1:]
                            & (col[:, 1:] < self.read_len[:, None])
                            & (xs[:, 1:] - xs[:, :-1] > 1))
        return self._del_ev

    @property
    def mism(self):
        if self._mism is None:
            hc = np.take_along_axis(
                self._pk_hap_codes,
                np.clip(self.xs - 1, 0, self.H_pad - 1), axis=1)
            self._mism = self.noins_on & (self._pk_read_codes != hc)
        return self._mism

    # --- per-row derivations (O(L) per call; per-pair consumers use
    # these so a handful of event pairs never force the full (B, L_pad)
    # matrices the native init skipped) ---

    def _ins_row(self, i: int):
        if self._ins_all is not None:
            return self._ins_all[i]
        return self._ms[i] >= (self.H_pad + 2)

    def _noins_on_row(self, i: int):
        if self._noins_on is not None:
            return self._noins_on[i]
        xs = self.xs[i]
        col = np.arange(self.L_pad)
        on = ((xs >= 1) & (xs <= self._hap_len[i])
              & (col < self.read_len[i]))
        return on & ~self._ins_row(i)

    def _del_row(self, i: int):
        if self._del_ev is not None:
            return self._del_ev[i]
        xs = self.xs[i]
        noins_on = self._noins_on_row(i)
        col = np.arange(1, self.L_pad)
        return (noins_on[:-1] & ~self._ins_row(i)[1:]
                & (col < self.read_len[i]) & (xs[1:] - xs[:-1] > 1))

    def _mism_row(self, i: int):
        if self._mism is not None:
            return self._mism[i]
        hc = self._pk_hap_codes[i][
            np.clip(self.xs[i] - 1, 0, self.H_pad - 1)]
        return self._noins_on_row(i) & (self._pk_read_codes[i] != hc)

    # --- 2-D (nh, nr) views of the flat hap-major arrays ---
    @property
    def ll2d(self):
        return self.ll.reshape(self.nh, self.nr)

    @property
    def off_hap2d(self):
        return self.off_hap.reshape(self.nh, self.nr)

    @property
    def off_hap_hmq2d(self):
        return self.off_hap_hmq.reshape(self.nh, self.nr)

    def __len__(self):
        return self.nh

    def __getitem__(self, h):
        return _LazyRow(self, h)

    def __iter__(self):
        return (self[h] for h in range(self.nh))

    def materialize(self) -> List[List[MLAlignment]]:
        return [[self._ml(h, r) for r in range(self.nr)]
                for h in range(self.nh)]

    def events(self, h: int, r: int):
        """MAP-path indel events of pair (h, r), or None."""
        if not self.has_event[h * self.nr + r]:
            return None
        key = (h, r)
        ev = self._events.get(key)
        if ev is None:
            ev = self._pair_events(h, r)
            self._events[key] = ev
        return ev

    def n_indel_entries_row(self, h: int) -> np.ndarray:
        """len(liks[h][r].indels) over r (distinct indel positions on the
        MAP path), computed once per haplotype row."""
        row = self._nind_rows.get(h)
        if row is None:
            row = np.zeros(self.nr, np.int64)
            base = h * self.nr
            for r in np.nonzero(self.has_event[base:base + self.nr])[0]:
                ev = self.events(h, int(r))
                row[int(r)] = len({e[-1] for e in ev})
            self._nind_rows[h] = row
        return row

    # ------------------------------------------------------------------
    def _pair_events(self, hi: int, ri: int):
        """MAP-path indel events for pair (hi, ri): (b, 'D', pos) or
        (entry, 'I', end, pos), sorted by read position."""
        i = hi * self.nr + ri
        L = self.reads[ri].size()
        Hh = self.haps[hi].size()
        xs = self.xs
        events = []
        for b in np.nonzero(self._del_row(i)[:max(L - 1, 0)])[0]:
            events.append((int(b), "D", int(xs[i, b])))
        ins_row = self._ins_row(i)[:L]
        if ins_row.any():
            # maximal ins runs; the loop enters a run at its first base
            # with 0 < x <= H and consumes to the run end (earlier bases
            # keep their LO/RO codes)
            d = np.diff(ins_row.astype(np.int8))
            starts = list(np.nonzero(d == 1)[0] + 1)
            ends = list(np.nonzero(d == -1)[0])
            if ins_row[0]:
                starts.insert(0, 0)
            if ins_row[L - 1]:
                ends.append(L - 1)
            for a, e in zip(starts, ends):
                entry = -1
                for b in range(a, e + 1):
                    xv = int(xs[i, b])
                    if 0 < xv <= Hh:
                        entry = b
                        break
                if entry >= 0:
                    events.append((entry, "I", int(e), int(xs[i, entry])))
        events.sort(key=lambda t: t[0])
        return events

    def _ml(self, hi: int, ri: int) -> MLAlignment:
        from ..variants import AlignedVariant
        from ..model import HPOS_INS

        cached = self._cache.get((hi, ri))
        if cached is not None:
            return cached
        i = hi * self.nr + ri
        hap = self.haps[hi]
        r = self.reads[ri]
        L = r.size()
        align_ref = "R" * hap.size()
        xs = self.xs
        ml = MLAlignment()
        ml.ll = float(self.ll[i])
        ml.off_hap = bool(self.off_hap[i])
        ml.off_hap_hmq = bool(self.off_hap_hmq[i])
        ml.ll_off = float(self.ll_off[i])
        ml.ll_on = float(self.ll_on[i])
        ml.hpos = self.hpos_all[i, :L].tolist()
        ml.first_base = int(self.fb[i])
        ml.last_base = int(self.lb[i])
        ml.n_bqt = int(self.n_bqt[i])
        ml.m_log_bq = float(self.m_log_bq[i])
        ml.n_mm_bqt = int(self.n_mm_bqt[i])
        ml.n_mm_left = int(self.n_mm_left[i])
        ml.n_mm_right = int(self.n_mm_right[i])
        ml.num_mismatch = int(self.num_mm[i])
        align = None
        if self.any_mism[i]:
            align = list(align_ref)
            for b in np.nonzero(self._mism_row(i)[:L])[0]:
                spos = int(xs[i, b]) - 1
                ml.snps[spos] = AlignedVariant(
                    hap.seq[spos] + "=>" + r.seq[b],
                    start_hap=spos, end_hap=spos,
                    start_read=int(b), end_read=int(b))
                align[spos] = r.seq[b]
        events = self.events(hi, ri)
        if events:
            # patch the indel events onto the vectorized decode (same
            # event rules as _report_variants; validated field-for-field
            # in tests/test_report_fast.py)
            if align is None:
                align = list(align_ref)
            for ev in events:
                if ev[1] == "D":
                    b, _, pos = ev
                    ns = int(xs[i, b + 1])
                    ln = ns - pos - 1
                    for y in range(pos, pos + ln):
                        align[y] = "D"
                    ml.indels[pos] = AlignedVariant(
                        "-" + hap.seq[pos:pos + ln],
                        start_hap=pos, end_hap=pos + ln - 1,
                        start_read=b, end_read=b + 1)
                    ml.num_indels += 1
                else:
                    entry, _, e, pos = ev
                    for b in range(entry, e + 1):
                        ml.hpos[b] = HPOS_INS
                    ml.indels[pos] = AlignedVariant(
                        "+" + r.seq[entry:e + 1],
                        start_hap=pos, end_hap=pos,
                        start_read=entry, end_read=e)
                    ml.num_indels += 1
        ml.align = "".join(align) if align is not None else align_ref
        for pos_, av in hap.indels.items():
            ml.hap_indel_covered[pos_] = av.is_covered(
                self.p.pad_cover, ml.first_base, ml.last_base)
        for pos_, av in hap.snps.items():
            ml.hap_snp_covered[pos_] = av.is_covered(
                self.p.pad_cover, ml.first_base, ml.last_base)
        self._cache[(hi, ri)] = ml
        return ml


class _LazyRow:
    """liks[h] under a LiksView: list-like row of lazy MLAlignments."""

    __slots__ = ("_v", "_h")

    def __init__(self, view: LiksView, h: int):
        self._v = view
        self._h = h

    def __getitem__(self, r):
        return self._v._ml(self._h, r)

    def __len__(self):
        return self._v.nr

    def __iter__(self):
        return (self._v._ml(self._h, r) for r in range(self._v.nr))


def decode_liks_view(haps: List[Haplotype], reads: List[Read],
                     pk: dict, ll, off_hap, off_hap_hmq, ll_off,
                     ll_on, map_state,
                     p: ObservationModelParameters) -> LiksView:
    """Array-level decode of the device outputs: O(1) per-pair Python.

    _report_variants (hmm/reference.py) is a per-base Python loop and
    the eager per-pair decode was the next bottleneck (PERF_NOTES.md);
    here hpos, first/last base, SNPs, align strings and mismatch
    statistics are batch array ops and per-pair MLAlignment objects are
    built only on demand (LiksView)."""
    return LiksView(haps, reads, pk, ll, off_hap, off_hap_hmq, ll_off,
                    ll_on, map_state, p)


def decode_map_alignments(haps: List[Haplotype], reads: List[Read],
                          pk: dict, ll, off_hap, off_hap_hmq, ll_off,
                          ll_on, map_state,
                          p: ObservationModelParameters
                          ) -> List[List[MLAlignment]]:
    """Whole-batch decode to eagerly materialized MLAlignment lists
    (decode_liks_view + materialize; kept for parity tests and callers
    that want plain lists)."""
    return decode_liks_view(haps, reads, pk, ll, off_hap, off_hap_hmq,
                            ll_off, ll_on, map_state, p).materialize()


# ---------------------------------------------------------------------------
# Device-side per-pair statistics + filter coverage (SURVEY.md §3.1:
# everything between bam_fetch and glfData.output becomes device code).
#
# The host decode path (native/decode.cpp + LiksView) derives per-pair
# alignment statistics from the fetched (B, L_pad) map_state planes —
# ~90% of a slab's result bytes.  _pair_stats computes the
# same quantities ON DEVICE from the map_state tensor that _finish
# already produced, so calling-only windows fetch a handful of (B,)
# scalars plus a tiny (B, V) coverage matrix instead.  Field-for-field
# parity with LiksView is asserted in tests/test_device_call.py.

@partial(jax.jit, static_argnames=("H_pad", "L_pad", "V"))
def _pair_stats(H_pad, L_pad, V, map_state, read_len, hap_len,
                read_idx, hap_idx, read_codes_r, hap_codes_h,
                bqt_r, q95_r, log10q_r,
                v_left_h, v_right_h, v_isdel_h, v_valid_h,
                off_hap_hmq, max_mismatch):
    """Per-pair MAP-path statistics (LiksView._init_native parity) and
    per-(pair, variant-slot) filter coverage (filterhaps view parity).

    v_*_h are (n_hap_rows, V) per-hap variant flank tables aligned with
    the compact hap tables; slot v of pair i refers to the v-th indel
    variant of hap hap_idx[i] (invalid slots masked by v_valid_h)."""
    B = map_state.shape[0]
    S_half = H_pad + 2
    RO = H_pad + 1
    ms = map_state.astype(jnp.int32)
    hl = hap_len.astype(jnp.int32)[:, None]
    rl = read_len.astype(jnp.int32)[:, None]
    read_codes = read_codes_r[read_idx]
    hap_codes = hap_codes_h[hap_idx]
    bqt_p = bqt_r[read_idx]
    q95_p = q95_r[read_idx]
    log10q_p = log10q_r[read_idx]

    ins = ms >= S_half
    x_all = ms % S_half
    xs = jnp.where(x_all == RO, hl + 1, x_all)
    col = jnp.arange(L_pad, dtype=jnp.int32)[None, :]
    validc = col < rl
    on = (xs >= 1) & (xs <= hl) & validc
    noins_on = on & ~ins
    ins_ev = ins & on
    del_ev = (noins_on[:, :-1] & ~ins[:, 1:] & (col[:, 1:] < rl)
              & (xs[:, 1:] - xs[:, :-1] > 1))
    has_event = ins_ev.any(axis=1) | del_ev.any(axis=1)

    big = jnp.int32(np.iinfo(np.int32).max)
    fb = jnp.where(noins_on, xs - 1, big).min(axis=1)
    fb = jnp.where(fb == big, -1, fb)
    lb = jnp.where(noins_on, xs - 1, -1).max(axis=1)

    bqt = noins_on & bqt_p
    hc = jnp.take_along_axis(hap_codes, jnp.clip(xs - 1, 0, H_pad - 1),
                             axis=1)
    mism = noins_on & (read_codes != hc)
    n_bqt = bqt.sum(axis=1, dtype=jnp.int32)
    n_mm_bqt = (mism & bqt).sum(axis=1, dtype=jnp.int32)
    n_mm_left = (mism & (col < 6)).sum(axis=1, dtype=jnp.int32)
    n_mm_right = (mism & (col > rl - 6)).sum(axis=1, dtype=jnp.int32)
    num_mm = (mism & q95_p).sum(axis=1, dtype=jnp.int32)
    any_mism = mism.any(axis=1)

    # sequential left-fold (bit-parity with the per-base loop: masked
    # terms add +0.0, an exact identity)
    mlq_terms = jnp.where(bqt, log10q_p, jnp.zeros((), log10q_p.dtype))

    def mlq_body(acc, t):
        return acc + t, None

    m_log_bq, _ = lax.scan(mlq_body,
                           jnp.zeros((B,), log10q_p.dtype),
                           mlq_terms.T, unroll=8)

    # distinct MAP-path indel-event positions (LiksView
    # n_indel_entries_row parity): one scan over read bases carrying
    # (last event pos, any-event, in-run-seen-entry, count).  Event
    # positions are non-decreasing along the path so adjacent-duplicate
    # collapse counts distinct dict keys exactly.
    del_trigger = jnp.concatenate(
        [del_ev, jnp.zeros((B, 1), bool)], axis=1)
    ev_inhap = ins & on  # candidate ins-entry bases

    def nind_body(carry, x):
        last_pos, has_prev, seen_run, count = carry
        ins_b, inhap_b, del_b, x_b = x
        entry = inhap_b & ~seen_run
        seen_run = jnp.where(ins_b, seen_run | inhap_b, False)
        ev = entry | del_b
        pos = x_b
        new = ev & (~has_prev | (pos != last_pos))
        count = count + new.astype(jnp.int32)
        last_pos = jnp.where(ev, pos, last_pos)
        has_prev = has_prev | ev
        return (last_pos, has_prev, seen_run, count), None

    zb = jnp.zeros((B,), bool)
    (_, _, _, n_ind), _ = lax.scan(
        nind_body,
        (jnp.zeros((B,), jnp.int32), zb, zb, jnp.zeros((B,), jnp.int32)),
        (ins.T, ev_inhap.T, del_trigger.T, xs.T), unroll=8)

    # filter coverage per variant slot (DInDel.cpp:1984-2071 semantics,
    # including the sentinel-code and negative-index quirks the view
    # implementation reproduces)
    hp = jnp.where(noins_on, xs - 1, jnp.where(xs == 0, -3, -4))
    sel = (~off_hap_hmq) & (~has_event)
    wrap = jnp.where(hp >= 0, hp, hl + hp)
    hchar = jnp.take_along_axis(hap_codes,
                                jnp.clip(wrap, 0, H_pad - 1), axis=1)
    mm_base = hchar != read_codes
    cov_cols = []
    for v in range(V):
        left = v_left_h[:, v][hap_idx][:, None]
        right = v_right_h[:, v][hap_idx][:, None]
        isdel = v_isdel_h[:, v][hap_idx]
        valid_v = v_valid_h[:, v][hap_idx]
        inr = (hp >= left) & (hp <= right) & validc
        c_noins = (inr & noins_on).sum(axis=1, dtype=jnp.int32)
        has_lo = (inr & (hp == -3)).any(axis=1)
        has_ro = (inr & (hp == -4)).any(axis=1)
        c_size = c_noins + has_lo.astype(jnp.int32) + has_ro.astype(jnp.int32)
        mm_v = inr & mm_base
        mm_v = jnp.where(isdel[:, None],
                         mm_v & (hchar != ord("N")), mm_v)
        nmm = mm_v.sum(axis=1, dtype=jnp.int32)
        ln = right[:, 0] - left[:, 0] + 1
        ok_mm = nmm <= max_mismatch
        del_ok = (c_size >= ln) & ok_mm
        ins_ok = ok_mm & (c_size == ln)
        cov_cols.append(sel & valid_v
                        & jnp.where(isdel, del_ok, ins_ok))
    cov_ok = (jnp.stack(cov_cols, axis=1) if V
              else jnp.zeros((B, 0), bool))
    return (fb.astype(jnp.int32), lb.astype(jnp.int32), n_bqt, n_mm_bqt,
            m_log_bq, n_mm_left, n_mm_right, num_mm, has_event, any_mism,
            n_ind, cov_ok)


class LiksStats:
    """Stats-only liks matrix: the device-computed per-pair scalars the
    callers (diploid, pooled, filter, guards) consume — no map_state
    planes, no per-base decode.  Exposes the same array attributes as
    LiksView; per-pair MLAlignment materialization is unavailable (the
    engine routes realigned-BAM/--opl windows through the full-decode
    path instead)."""

    def __init__(self, haps, reads, p, read_len, hap_len, fetched: dict):
        self.haps = haps
        self.reads = reads
        self.p = p
        self.nh = len(haps)
        self.nr = len(reads)
        self.read_len = read_len
        self._hap_len = hap_len
        self.ll = np.asarray(fetched["ll"], np.float64)
        self.off_hap = np.asarray(fetched["off_hap"], bool)
        self.off_hap_hmq = np.asarray(fetched["off_hap_hmq"], bool)
        self.ll_off = np.asarray(fetched["ll_off"], np.float64)
        self.ll_on = np.asarray(fetched["ll_on"], np.float64)
        self.fb = np.asarray(fetched["fb"], np.int64)
        self.lb = np.asarray(fetched["lb"], np.int64)
        self.n_bqt = np.asarray(fetched["n_bqt"], np.int64)
        self.n_mm_bqt = np.asarray(fetched["n_mm_bqt"], np.int64)
        self.m_log_bq = np.asarray(fetched["m_log_bq"], np.float64)
        self.n_mm_left = np.asarray(fetched["n_mm_left"], np.int64)
        self.n_mm_right = np.asarray(fetched["n_mm_right"], np.int64)
        self.num_mm = np.asarray(fetched["num_mm"], np.int64)
        self.has_event = np.asarray(fetched["has_event"], bool)
        self.any_mism = np.asarray(fetched["any_mism"], bool)
        self._n_ind = np.asarray(fetched["n_ind"], np.int64)
        self.cov_ok = np.asarray(fetched["cov_ok"], bool)

    @property
    def ll2d(self):
        return self.ll.reshape(self.nh, self.nr)

    @property
    def off_hap2d(self):
        return self.off_hap.reshape(self.nh, self.nr)

    @property
    def off_hap_hmq2d(self):
        return self.off_hap_hmq.reshape(self.nh, self.nr)

    def n_indel_entries_row(self, h: int) -> np.ndarray:
        return self._n_ind[h * self.nr:(h + 1) * self.nr]

    def __len__(self):
        return self.nh

    def __getitem__(self, h):
        raise TypeError(
            "LiksStats has no per-pair MLAlignments (map_state was not "
            "fetched); use the full-decode path for per-pair consumers")


def _expand_prior(pr: np.ndarray, Hh: int, H_pad: int) -> np.ndarray:
    """Per-hap prior (2*(Hh+2),) -> fixed layout (2*(H_pad+2),)."""
    numS = Hh + 2
    S_half = H_pad + 2
    out = np.full(2 * S_half, NEGBIG)
    for i in range(2):
        out[i * S_half:i * S_half + Hh + 1] = pr[i * numS:i * numS + Hh + 1]
        out[i * S_half + H_pad + 1] = pr[i * numS + Hh + 1]
    return out
