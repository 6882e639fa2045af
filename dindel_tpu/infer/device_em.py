"""Pooled VB-EM on device: the per-active-set EM iteration
(DInDel.cpp:2431-2523) as ONE jitted fixed-point loop over every active
set of every pooled window in a batch.

Production path only (f32, x64 off): the host numpy loop in
infer/pooled.py remains the byte-parity anchor (its digamma replicates
boost::math::digamma and its folds replay the reference accumulation
order; the device uses jax.scipy.special.digamma and dense reductions).
tests/test_device_em.py A/Bs the two engines with the same
zero-rescue discipline as tests/test_device_call.py.

Batched across windows because a per-window dispatch costs more
latency than the whole host EM; all (window, active-set) instances of a
batch pad into one (S, NR, NH) tensor."""

from __future__ import annotations

import math
from functools import partial
from typing import List, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(jax.jit, static_argnames=("max_iter",))
def _em_kernel(rl, rmask, compat, numah, nr, a0, tol, max_iter=27):
    """rl: (S, NR, NH) read-given-hap log-liks (pad rows arbitrary);
    rmask: (S, NR) valid-read mask; compat: (S, NH); numah: (S,);
    nr: (S,) float read counts.  Returns (loglik, pi): (S,), (S, NH).

    Mirrors the reference iteration structure (DInDel.cpp:2431-2523):
    lpi init log(1/numah) on compatible haps / -100 elsewhere;
    responsibilities -> nk -> Dirichlet update (digamma) -> lpi;
    pi = log((a0+nk)/(numah*a0+nr)); converged when |e_old - e_new| <
    EMtol or 26 iterations ran.  Each set FREEZES at its own
    convergence (extra iterations must not move converged sets)."""
    S, NR, NH = rl.shape
    dt = rl.dtype
    lpi0 = jnp.where(compat, -jnp.log(numah)[:, None].astype(dt),
                     jnp.asarray(-100.0, dt))
    neg = jnp.asarray(-jnp.inf, dt)

    def body(state):
        lpi, pi, loglik, e_old, done, it = state
        Z = lpi[:, None, :] + rl                       # (S, NR, NH)
        lognorm = jax.nn.logsumexp(Z, axis=-1)         # (S, NR)
        zz = jnp.exp(Z - lognorm[..., None]) * rmask[..., None]
        nk = zz.sum(axis=1)                            # (S, NH)
        loglik_new = jnp.where(rmask, lognorm, 0.0).sum(axis=1)
        ak = jnp.where(compat, nk + a0, 0.0)
        ahat = ak.sum(axis=-1)
        dig_ak = jax.scipy.special.digamma(jnp.where(compat, ak, 1.0))
        lpi_new = jnp.where(compat,
                            dig_ak
                            - jax.scipy.special.digamma(ahat)[:, None],
                            jnp.asarray(-100.0, dt))
        pi_new = jnp.where(
            compat,
            jnp.log((a0 + nk) / (numah * a0 + nr)[:, None]),
            jnp.asarray(-100.0, dt))
        e_new = (zz * (pi_new[:, None, :] + rl)).sum(axis=(1, 2))
        conv = (jnp.abs(e_old - e_new) < tol) | (it > 25)
        upd = ~done
        u2 = upd[:, None]
        return (jnp.where(u2, lpi_new, lpi), jnp.where(u2, pi_new, pi),
                jnp.where(upd, loglik_new, loglik),
                jnp.where(upd, e_new, e_old), done | (conv & upd), it + 1)

    def cond(state):
        done, it = state[4], state[5]
        return (~jnp.all(done)) & (it < max_iter)

    state0 = (lpi0, jnp.full((S, NH), -100.0, dt), jnp.zeros((S,), dt),
              jnp.full((S,), neg), jnp.zeros((S,), bool),
              jnp.asarray(0, jnp.int32))
    lpi, pi, loglik, _e, _d, _it = lax.while_loop(cond, body, state0)
    return loglik, pi


def run_batched_em(instances: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                   a0: float, tol: float, dtype=np.float32):
    """instances: per pooled window, (rlT (nr, nh), compat (nav, nh) bool,
    numah (nav,)).  Returns per window a list of (loglik, pi) per active
    set (numpy float64)."""
    if not instances:
        return []
    NR = _round_up(max(r.shape[0] for r, _, _ in instances), 64)
    NH = max(r.shape[1] for r, _, _ in instances)
    S = sum(c.shape[0] for _, c, _ in instances)
    Sp = max(8, 1 << (S - 1).bit_length())
    rl = np.zeros((Sp, NR, NH), dtype)
    rmask = np.zeros((Sp, NR), bool)
    compat = np.zeros((Sp, NH), bool)
    numah = np.ones(Sp, dtype)
    nrv = np.ones(Sp, dtype)
    s = 0
    spans = []
    for rlT, cp, na in instances:
        nr, nh = rlT.shape
        nav = cp.shape[0]
        for a in range(nav):
            rl[s, :nr, :nh] = rlT
            rmask[s, :nr] = True
            compat[s, :nh] = cp[a]
            numah[s] = max(float(na[a]), 1.0)
            nrv[s] = float(nr)
            s += 1
        spans.append((s - nav, s))
    loglik, pi = _em_kernel(jnp.asarray(rl), jnp.asarray(rmask),
                            jnp.asarray(compat), jnp.asarray(numah),
                            jnp.asarray(nrv), dtype(a0), dtype(tol))
    loglik = np.asarray(loglik, np.float64)
    pi = np.asarray(pi, np.float64)
    out = []
    for (lo, hi), (rlT, cp, _na) in zip(spans, instances):
        nh = rlT.shape[1]
        out.append([(float(loglik[s]), pi[s, :nh].copy())
                    for s in range(lo, hi)])
    return out
