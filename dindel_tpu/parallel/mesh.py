"""Multi-chip execution: windows data-parallel ('dp') and reads
tensor-parallel ('rp') over a jax.sharding.Mesh.

The reference scales by running one process per window file with zero
communication (makeWindows.py:46-54); this design shards a *batch of
windows* over a device mesh instead:

- 'dp' axis: independent realignment windows (the natural data axis);
- 'rp' axis: the reads of each window are sharded across chips; per-pair
  log-likelihoods are computed locally and the diploid genotype
  log-likelihood matrix G[h1,h2] = sum_r log(.5 e^{ll[h1,r]}+.5 e^{ll[h2,r]})
  is completed with a psum over 'rp' (the tensor-parallel analogue for
  this workload).

The same step function drives dryrun_multichip (virtual CPU devices) and
multi-GPU runs.  Every device reaches every other at the same rate, so
make_mesh is a flat device list with no topology."""

from __future__ import annotations

import math
from functools import partial
from typing import List

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
import warnings
with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    # the jax.shard_map variant enforces varying-manual-axes typing on
    # scan carries, which the DP scans don't annotate; the experimental
    # entry point with check_rep=False matches our replication semantics
    from jax.experimental.shard_map import shard_map

from ..config import ObservationModelParameters
from ..hmm.batch import (_finish, compute_obs_mid, get_dp_impl, pack_pairs,
                         _round_up)
from ..model import Haplotype, Read

PACK_KEYS = ["hap_len", "read_len", "b_mid", "read_codes", "hap_codes",
             "eq", "uq", "lpe", "lpn", "lpeV", "lpnV",
             "prior_rmq", "prior_hmq", "obs_mid"]


def make_mesh(n_dp: int, n_rp: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    devs = np.asarray(devices[:n_dp * n_rp]).reshape(n_dp, n_rp)
    return Mesh(devs, axis_names=("dp", "rp"))


def _window_step_local(H_pad, L_pad, numT, nh, dp_impl, args):
    """Per-shard computation: batched HMM over the local (window, hap,
    read-shard) pairs + partial genotype matrix, completed by psum.
    dp_impl selects the DP implementation ("xla" or "fused")."""
    (hap_len, read_len, b_mid, read_codes, hap_codes, eq, uq,
     lpe, lpn, lpeV, lpnV, prior_rmq, prior_hmq, obs_mid, read_mask,
     scalars) = args

    W_loc = hap_len.shape[0]
    dp = get_dp_impl(dp_impl)

    def one_window(a):
        (hl, rl, bm, rc, hc, e, u, le, ln, leV, lnV, prr, prh, om, sc) = a
        amid, bmid_, btf, btb = dp(H_pad, L_pad, numT, hl, rl, bm, rc,
                                   hc, e, u, le, ln, leV, lnV, sc)
        out = _finish(H_pad, L_pad, bm, amid, bmid_, om, prr, prh, btf, btb,
                      bt_codes=(dp_impl == "fused"), numT=numT, hap_len=hl)
        return out[0]  # ll, (B,) = (nh * nr_loc,)

    ll = jax.vmap(one_window)(
        (hap_len, read_len, b_mid, read_codes, hap_codes, eq, uq,
         lpe, lpn, lpeV, lpnV, prior_rmq, prior_hmq, obs_mid,
         jnp.broadcast_to(scalars, (W_loc,) + scalars.shape)))
    nr_loc = ll.shape[1] // nh
    ll = ll.reshape(W_loc, nh, nr_loc)
    mask = read_mask.reshape(W_loc, nh, nr_loc)
    # diploid pair posteriors: G[w,h1,h2] = sum_r log(.5 e^l1 + .5 e^l2);
    # pairs padded onto the rp axis contribute 0
    l1 = ll[:, :, None, :]
    l2 = ll[:, None, :, :]
    pair = jnp.logaddexp(l1, l2) + jnp.log(0.5)
    pair = jnp.where(mask[:, :, None, :], pair, 0.0)
    G_local = pair.sum(axis=-1)
    G = lax.psum(G_local, axis_name="rp")
    return ll, G


def sharded_window_step(mesh: Mesh, H_pad: int, L_pad: int, numT: int,
                        nh: int, dp_impl: str = "xla"):
    """Returns a jitted function over a packed window batch:
    inputs (W, B, ...) sharded windows over 'dp', pairs over 'rp'."""
    fn = partial(_window_step_local, H_pad, L_pad, numT, nh, dp_impl)
    in_spec = ((P("dp", "rp"),) * 3 + (P("dp", "rp", None),) * 11
               + (P("dp", "rp"), P()))

    def wrapper(*args):
        return fn(args)

    sm = shard_map(wrapper, mesh=mesh,
                   in_specs=in_spec,
                   out_specs=(P("dp", None, "rp"), P("dp", None, None)),
                   check_rep=False)
    return jax.jit(sm)


def pack_window_batch(windows, params: ObservationModelParameters,
                      dtype=np.float32, H_pad=None, L_pad=None, n_rp: int = 1):
    """windows: list of (haps, reads, hap_start) with identical nh, nr.
    Returns stacked arrays (W, B, ...) + dims.  The pair axis is permuted
    from hap-major (h*nr+r) to (read-shard, hap, read) order so a
    contiguous 'rp' split keeps all haps with each read shard."""
    pks = []
    H_max = max(max(h.size() for h in w[0]) for w in windows)
    L_max = max(max(r.size() for r in w[1]) for w in windows)
    if H_pad is None:
        H_pad = ((H_max + 15) // 16) * 16
    if L_pad is None:
        L_pad = ((max(L_max, 2) + 15) // 16) * 16
    for haps, reads, hap_start in windows:
        pk = pack_pairs(haps, reads, hap_start, params, dtype,
                        H_pad=H_pad, L_pad=L_pad)
        pk["obs_mid"] = compute_obs_mid(pk)
        pks.append(pk)
    nh = pks[0]["nh"]
    nr = pks[0]["nr"]
    # pad the read axis up to a multiple of the rp shard count (clones of
    # the last read; masked out of the psum'd genotype matrix)
    nr_pad = _round_up(nr, n_rp)
    nr_loc = nr_pad // n_rp
    pair_of = np.arange(nr_pad)
    pair_of = np.where(pair_of < nr, pair_of, nr - 1)
    perm = np.array([h * nr + pair_of[s * nr_loc + r]
                     for s in range(n_rp)
                     for h in range(nh)
                     for r in range(nr_loc)], np.int64)
    real = np.array([(s * nr_loc + r) < nr
                     for s in range(n_rp)
                     for h in range(nh)
                     for r in range(nr_loc)], bool)
    stacked = [np.stack([pk[k][perm] for pk in pks]) for k in PACK_KEYS]
    stacked.append(np.broadcast_to(real, (len(pks), real.shape[0])).copy())
    stacked.append(pks[0]["scalars"])
    return stacked, pks[0]["H_pad"], pks[0]["L_pad"], pks[0]["numT"], nh


def synth_windows(n_windows: int, nh: int, nr: int, H: int, L: int, seed: int = 0):
    """Small synthetic windows for dry runs and benchmarks."""
    import random
    rng = random.Random(seed)
    out = []
    for w in range(n_windows):
        ref = "".join(rng.choice("ACGT") for _ in range(H))
        haps = [Haplotype(seq=ref)]
        for _ in range(nh - 1):
            k = rng.randrange(5, H - 8)
            if rng.random() < 0.5:
                haps.append(Haplotype(seq=ref[:k] + ref[k + rng.randint(1, 3):]))
            else:
                ins = "".join(rng.choice("ACGT") for _ in range(rng.randint(1, 3)))
                haps.append(Haplotype(seq=ref[:k] + ins + ref[k:]))
        reads = []
        for _ in range(nr):
            src = haps[rng.randrange(nh)].seq
            start = rng.randrange(0, max(1, len(src) - L))
            seq = src[start:start + L]
            if len(seq) < L:
                seq = seq + "".join(rng.choice("ACGT") for _ in range(L - len(seq)))
            reads.append(Read(seq=seq,
                              qual=np.full(L, 0.999),
                              map_qual=1 - 1e-5,
                              pos_stat_first=float(start)))
        out.append((haps, reads, 0))
    return out


def dryrun_multichip(n_devices: int) -> None:
    """Driver contract: build an n-device mesh and run BOTH multi-chip
    paths on tiny shapes:

    1. the production slab step the batched engine dispatches
       (hmm.batch.run_packed_compact_sharded — pairs sharded over the
       full dp x rp mesh), asserted bit-equal to the single-device run;
    2. the dp x rp window step with the rp psum collective
       (sharded_window_step), including an uneven read count that pads
       onto the rp axis."""
    devices = jax.devices()
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    n_rp = 2 if n_devices % 2 == 0 else 1
    n_dp = n_devices // n_rp
    mesh = make_mesh(n_dp, n_rp, devices)

    nh = 3
    nr = 4 * n_rp + 1  # deliberately uneven over rp
    W = 2 * n_dp
    windows = synth_windows(W, nh, nr, H=48, L=32)
    params = ObservationModelParameters()

    # 1. engine slab path, sharded vs single device
    from ..hmm.batch import (merge_compact, pack_pairs_compact, pad_compact,
                             run_packed_compact, run_packed_compact_sharded)
    pks = [pack_pairs_compact(haps, reads, hs, params, np.float32,
                              H_pad=62, L_pad=32)
           for haps, reads, hs in windows]
    merged = pad_compact(merge_compact(pks))
    ref = [np.asarray(o) for o in run_packed_compact(merged, "xla")]
    got = [np.asarray(o)
           for o in run_packed_compact_sharded(merged, "xla", mesh)]
    for a, b in zip(ref, got):
        assert a.shape == b.shape and (a == b).all(), \
            "sharded slab step diverged from single-device"

    # 2. dp x rp window step with the rp psum
    args, H_pad, L_pad, numT, nh_ = pack_window_batch(
        windows, params, dtype=np.float32, n_rp=n_rp)
    step = sharded_window_step(mesh, H_pad, L_pad, numT, nh_)
    with mesh:
        ll, G = step(*[jnp.asarray(a) for a in args])
        ll.block_until_ready()
    nr_pad = _round_up(nr, n_rp)
    assert ll.shape == (W, nh, nr_pad)
    assert G.shape == (W, nh, nh)
    assert bool(jnp.isfinite(G).all())

    # 3. the fused DP kernel under the mesh (--hmmBackend fused --mesh):
    #    f32, argmax finish, sharded vs single device.  The kernel's
    #    platform build runs: CUDA on GPUs, the host build on CPU.
    got = [np.asarray(o)
           for o in run_packed_compact_sharded(merged, "fused", mesh)]
    for a, b in zip(run_packed_compact(merged, "fused"), got):
        assert a.shape == b.shape and (np.asarray(a) == b).all(), \
            "sharded fused slab step diverged from single-device"
