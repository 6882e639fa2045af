"""The fused DP kernel (hmm/fused.py; the host build of the same code the
CUDA kernel runs) against the XLA DP: identical alpha/beta bMid slices
and backpointers on the rows _finish consumes, identical _finish
outputs.  The byte code format is also pinned by a numpy encoder of
_dp_xla's backpointers, independent of the kernel."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dindel_tpu.config import ObservationModelParameters
from dindel_tpu.hmm.batch import (pack_pairs, _dp_xla, _finish,
                                  compute_obs_mid, get_dp_impl)
from dindel_tpu.hmm.fused import dp_fused, encode_bt_codes, expand_bt_codes
from dindel_tpu.parallel.mesh import synth_windows

KEYS = ["hap_len", "read_len", "b_mid", "read_codes", "hap_codes",
        "eq", "uq", "lpe", "lpn", "lpeV", "lpnV"]


def _packed(nh, nr, H, L, seed, **kw):
    params = ObservationModelParameters()
    (haps, reads, hs), = synth_windows(1, nh=nh, nr=nr, H=H, L=L, seed=seed)
    pk = pack_pairs(haps, reads, hs, params, dtype=np.float32, **kw)
    args = [jnp.asarray(pk[k]) for k in KEYS] + [jnp.asarray(pk["scalars"])]
    return pk, args


def _consumed(pk):
    """Masks of the backpointer rows _finish reads: forward rows below
    b_mid, backward rows from b_mid up."""
    r = np.arange(pk["L_pad"] - 1)[:, None, None]
    bm = np.asarray(pk["b_mid"])[None, :, None]
    return r < bm, r >= bm


def _fin(pk, dp_out, bt_codes):
    return [np.asarray(o) for o in _finish(
        pk["H_pad"], pk["L_pad"], jnp.asarray(pk["b_mid"]), *dp_out[:2],
        jnp.asarray(compute_obs_mid(pk)), jnp.asarray(pk["prior_rmq"]),
        jnp.asarray(pk["prior_hmq"]), *dp_out[2:], exact_ties=True,
        bt_codes=bt_codes, numT=pk["numT"],
        hap_len=jnp.asarray(pk["hap_len"]))]


def _assert_finish_equal(pk, ref, got):
    valid = (np.arange(pk["L_pad"])[None, :]
             < np.asarray(pk["read_len"])[:, None])
    names = ("ll", "off_hap", "off_hap_hmq", "ll_off", "ll_on", "map_state")
    for nm, a, b in zip(names, ref, got):
        if nm == "map_state":
            a = np.where(valid, a, -1)
            b = np.where(valid, b, -1)
        assert np.array_equal(a, b), nm


@pytest.mark.parametrize("shape", [(4, 32, 80, 14, 3, 126, 16),
                                   (8, 24, 160, 100, 1, None, None)])
def test_fused_matches_xla(shape):
    nh, nr, H, L, seed, H_pad, L_pad = shape
    pk, args = _packed(nh, nr, H, L, seed, H_pad=H_pad, L_pad=L_pad)
    a1, b1, f1, g1 = [np.asarray(x) for x in _dp_xla(
        pk["H_pad"], pk["L_pad"], pk["numT"], *args)]
    a2, b2, f2c, g2c = [np.asarray(x) for x in dp_fused(
        pk["H_pad"], pk["L_pad"], pk["numT"], *args)]
    assert f2c.dtype == np.uint8
    assert f2c.shape == g2c.shape == (pk["L_pad"] - 1, nh * nr,
                                      pk["H_pad"] + 2)
    f2, g2 = expand_bt_codes(f2c, g2c, pk["hap_len"], pk["H_pad"],
                             pk["numT"])
    fm, gm = _consumed(pk)
    assert np.array_equal(a1, a2)
    assert np.array_equal(b1, b2)
    assert ((f1.astype(np.int32) != f2) & fm).sum() == 0
    assert ((g1.astype(np.int32) != g2) & gm).sum() == 0
    # rows from read_len-1 up are the padded slice: "self" codes
    rows = np.arange(pk["L_pad"] - 1)[:, None]
    pad = rows >= (np.asarray(pk["read_len"]) - 1)[None, :]
    assert (g2c[pad] == pk["numT"]).all()


def test_fused_finish_matches_xla():
    """End-of-contract check: dp_fused + _finish(bt_codes=True) equals
    _dp_xla + _finish on every output, valid map_state region included."""
    pk, args = _packed(3, 16, 70, 24, 9, H_pad=126, L_pad=32)
    ref = _fin(pk, _dp_xla(pk["H_pad"], pk["L_pad"], pk["numT"], *args),
               False)
    got = _fin(pk, dp_fused(pk["H_pad"], pk["L_pad"], pk["numT"], *args),
               True)
    _assert_finish_equal(pk, ref, got)


@pytest.mark.parametrize("seed", [4, 12])
def test_encoded_xla_backpointers_decode_in_finish(seed):
    """The numpy encoder of _dp_xla backpointers into the kernel's byte
    codes is the inverse of expand_bt_codes on the consumed rows, and
    _finish(bt_codes=True) over the encoded codes reproduces
    _dp_xla + _finish exactly — the code format alone, with no kernel."""
    pk, args = _packed(4, 20, 60, 40, seed)
    amid, bmid, btf, btb = [np.asarray(x) for x in _dp_xla(
        pk["H_pad"], pk["L_pad"], pk["numT"], *args)]
    cf, cb = encode_bt_codes(btf, btb, pk["hap_len"], pk["H_pad"],
                             pk["numT"])
    ef, eb = expand_bt_codes(cf, cb, pk["hap_len"], pk["H_pad"], pk["numT"])
    fm, gm = _consumed(pk)
    assert ((btf.astype(np.int32) != ef) & fm).sum() == 0
    assert ((btb.astype(np.int32) != eb) & gm).sum() == 0
    ref = _fin(pk, (amid, bmid, btf, btb), False)
    got = _fin(pk, (amid, bmid, jnp.asarray(cf), jnp.asarray(cb)), True)
    _assert_finish_equal(pk, ref, got)


def test_fused_wrapper_contract():
    """Kernel choice and the wrapper's guards: float32 only, 4-bit
    codes (numT <= 15), shapes matching H_pad/L_pad; vmap runs the
    kernel per batch element (the mesh window step vmaps over windows)."""
    assert get_dp_impl("fused") is dp_fused
    assert get_dp_impl("xla") is _dp_xla
    with pytest.raises(ValueError):
        get_dp_impl("unknown")
    pk, args = _packed(2, 8, 40, 20, 5)
    H_pad, L_pad, numT = pk["H_pad"], pk["L_pad"], pk["numT"]
    with pytest.raises(ValueError, match="numT"):
        dp_fused(H_pad, L_pad, 16, *args)
    a64 = list(args)
    a64[5] = a64[5].astype(jnp.float64)
    with pytest.raises(TypeError, match="float32"):
        dp_fused(H_pad, L_pad, numT, *a64)
    with pytest.raises(ValueError, match="shapes"):
        dp_fused(H_pad + 16, L_pad, numT, *args)
    single = [np.asarray(x) for x in dp_fused(H_pad, L_pad, numT, *args)]
    stacked = [jnp.stack([a, a]) for a in args[:-1]]
    batched = jax.vmap(lambda *a: dp_fused(H_pad, L_pad, numT, *a,
                                           args[-1]))(*stacked)
    for s, b in zip(single[:2], batched[:2]):
        assert np.array_equal(np.asarray(b)[1], s)
