"""Device-side calling parity: the production device-call path (per-pair
stats + filter coverage + diploid folds on device, infer/device_call.py +
hmm.batch._pair_stats) must reproduce the host anchor callers
byte-for-byte in float64.

Covers VERDICT r3 item 1: hot loops #3-#4 (DInDel.cpp:3085-3113,
:2431-2523 inputs) as device code, with the host caller kept as the
differential anchor."""

import numpy as np
import pytest

from dindel_tpu.config import Parameters
from dindel_tpu.engine.batched import BatchedWindowEngine
from dindel_tpu.engine.candidates import get_candidates
from dindel_tpu.pipeline.windows import make_windows
from dindel_tpu.sim import PlantedVariant, SimConfig, simulate


def _sim(tmp_path, seed, n_var=6, coverage=18, ref_len=7000):
    rng = np.random.RandomState(seed)
    spacing = ref_len // (n_var + 2)
    variants = []
    for i in range(n_var):
        kind = rng.randint(3)
        if kind == 0:
            var = "-" + "ACGT"[rng.randint(4)] * rng.randint(1, 4)
        elif kind == 1:
            var = "+" + "".join("ACGT"[rng.randint(4)]
                                for _ in range(rng.randint(1, 4)))
        else:
            var = "-AC"
        variants.append(PlantedVariant(pos=(i + 1) * spacing, var=var,
                                       genotype=1 + rng.randint(2)))
    cfg = SimConfig(ref_len=ref_len, coverage=coverage, read_len=70)
    fa, bam = simulate(str(tmp_path / f"sim{seed}"), variants, cfg,
                       seed=seed)
    var_file, _ = get_candidates(bam, str(tmp_path / f"cand{seed}"), fa)
    win_files = make_windows(var_file, str(tmp_path / f"win{seed}"))
    return fa, bam, win_files


def _run_engine(tmp_path, fa, bam, win_files, device_call, dtype,
                pooled=False, tag="x", batch_windows=128):
    params = Parameters()
    params.do_diploid = True
    if pooled:
        params.estimate_hap_freqs = True
        params.bayes_type = "singlevariant"
    params.file_name = str(tmp_path / f"out_{tag}")
    eng = BatchedWindowEngine([bam], fa, params, dtype=dtype,
                              device_call=device_call,
                              batch_windows=batch_windows,
                              max_pairs_per_slab=4096)
    glf = str(tmp_path / f"out_{tag}.glf.txt")
    rows = []
    for wf in win_files:
        rows.extend(eng.detect_indels(wf, glf))
    # a device-path crash would fall back to the rescue engine and make
    # the A/B comparison vacuous
    assert eng.stats.stage_seconds.get("slab_rescues", 0) == 0
    eng.close()
    return rows, open(glf).read()


@pytest.mark.parametrize("seed", [3, 11])
def test_device_call_glf_byte_identical_f64(tmp_path, seed):
    fa, bam, wfs = _sim(tmp_path, seed)
    rows_h, glf_h = _run_engine(tmp_path, fa, bam, wfs, False,
                                np.float64, tag="host")
    rows_d, glf_d = _run_engine(tmp_path, fa, bam, wfs, True,
                                np.float64, tag="dev")
    assert glf_h == glf_d
    assert rows_h == rows_d


def test_device_call_glf_byte_identical_f32(tmp_path):
    """The production numeric config: f32 DP, f64 host bookkeeping.
    Both engines fetch the same f32 ll values, so the f64 folds agree."""
    fa, bam, wfs = _sim(tmp_path, 7)
    _, glf_h = _run_engine(tmp_path, fa, bam, wfs, False, np.float32,
                           tag="host32")
    _, glf_d = _run_engine(tmp_path, fa, bam, wfs, True, np.float32,
                           tag="dev32")
    assert glf_h == glf_d


def test_device_call_pooled_parity(tmp_path):
    """Pooled VB-EM consumes the device LiksStats view (ll/off/coverage):
    byte-identical GLF vs the full-decode path."""
    fa, bam, wfs = _sim(tmp_path, 5, n_var=4, ref_len=5000)
    _, glf_h = _run_engine(tmp_path, fa, bam, wfs, False, np.float64,
                           pooled=True, tag="ph")
    _, glf_d = _run_engine(tmp_path, fa, bam, wfs, True, np.float64,
                           pooled=True, tag="pd")
    assert glf_h == glf_d


def test_device_call_small_batches(tmp_path):
    """Many small slabs/batches (slab and batch boundaries inside the
    window stream) still agree."""
    fa, bam, wfs = _sim(tmp_path, 13, n_var=5, ref_len=6000)
    _, glf_h = _run_engine(tmp_path, fa, bam, wfs, False, np.float64,
                           tag="sh", batch_windows=2)
    _, glf_d = _run_engine(tmp_path, fa, bam, wfs, True, np.float64,
                           tag="sd", batch_windows=2)
    assert glf_h == glf_d


def test_window_call_matches_host_folds():
    """The on-device fold (f32 production path) agrees with the host
    anchor folds to float64 exp-rounding noise (~1e-9 relative); exact
    equality is not required because XLA and numpy exp/log differ by an
    ulp on some inputs (see host_window_folds docstring)."""
    import math
    import jax.numpy as jnp
    from dindel_tpu.infer.device_call import (host_window_folds,
                                              pair_enum, _window_call)

    rng = np.random.RandomState(0)
    nh, nr, S = 4, 37, 3
    ll = -rng.gamma(2.0, 40.0, size=(nh, nr)).astype(np.float32)
    h1v, h2v = pair_enum(nh)
    np_pair = len(h1v)
    pair_pr = -rng.rand(S, np_pair) * 10
    ctab = dict(h1v=h1v, h2v=h2v, pair_pr=pair_pr,
                var_positions=list(range(S)))
    hb, hs = host_window_folds(ll, ctab)

    W, NH, NR = 8, nh, 64
    index_map = np.zeros((W, NH, NR), np.int32)
    index_map[0, :nh, :nr] = (np.arange(nh)[:, None] * nr
                              + np.arange(nr)[None, :])
    nr_w = np.zeros(W, np.int32)
    nr_w[0] = nr
    pp = np.zeros((W, 4, np_pair))
    pp[0, :S] = pair_pr
    base, site = _window_call(W, NH, 4, NR, jnp.asarray(ll.ravel()),
                              jnp.asarray(index_map), jnp.asarray(nr_w),
                              jnp.asarray(pp))
    np.testing.assert_allclose(np.asarray(base)[0], hb, rtol=1e-12,
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(site)[0, :S], hs, rtol=1e-12,
                               atol=1e-8)


def test_pair_stats_matches_liks_view():
    """Unit parity of the device per-pair stats vs the host decode
    (LiksView) on synthetic windows."""
    from dindel_tpu.config import ObservationModelParameters
    from dindel_tpu.hmm.batch import (decode_liks_view, expand_compact_host,
                                      merge_compact, pack_pairs_compact,
                                      pad_compact, run_packed_compact,
                                      run_packed_compact_stats)
    from dindel_tpu.parallel.mesh import synth_windows

    windows = synth_windows(3, nh=3, nr=5, H=40, L=24, seed=2)
    params = ObservationModelParameters()
    pks = [pack_pairs_compact(haps, reads, hs, params, np.float64,
                              H_pad=46, L_pad=32)
           for haps, reads, hs in windows]
    merged = pad_compact(merge_compact(pks))
    vtab = dict(v_left_h=np.zeros((merged["hap_codes_h"].shape[0], 2),
                                  np.int32),
                v_right_h=np.zeros((merged["hap_codes_h"].shape[0], 2),
                                   np.int32),
                v_isdel_h=np.zeros((merged["hap_codes_h"].shape[0], 2),
                                   bool),
                v_valid_h=np.zeros((merged["hap_codes_h"].shape[0], 2),
                                   bool))
    res = run_packed_compact_stats(merged, "xla", vtab, 2,
                                   want_map_state=True)
    import jax
    got = jax.device_get(res)

    out = run_packed_compact(merged, "xla")
    ll, off, offh, ll_off, ll_on, ms = [np.asarray(o) for o in out]
    offset = 0
    for (haps, reads, hs), pk in zip(windows, pks):
        B = pk["hap_len"].shape[0]
        sl = slice(offset, offset + B)
        dense = expand_compact_host(pk)
        view = decode_liks_view(haps, reads, dense, ll[sl], off[sl],
                                offh[sl], ll_off[sl], ll_on[sl],
                                np.asarray(ms[sl]), params)
        np.testing.assert_array_equal(np.asarray(got["fb"][sl]), view.fb)
        np.testing.assert_array_equal(np.asarray(got["lb"][sl]), view.lb)
        np.testing.assert_array_equal(np.asarray(got["n_bqt"][sl]),
                                      view.n_bqt)
        np.testing.assert_array_equal(np.asarray(got["n_mm_bqt"][sl]),
                                      view.n_mm_bqt)
        np.testing.assert_array_equal(np.asarray(got["n_mm_left"][sl]),
                                      view.n_mm_left)
        np.testing.assert_array_equal(np.asarray(got["n_mm_right"][sl]),
                                      view.n_mm_right)
        np.testing.assert_array_equal(np.asarray(got["num_mm"][sl]),
                                      view.num_mm)
        np.testing.assert_array_equal(np.asarray(got["has_event"][sl]),
                                      view.has_event)
        np.testing.assert_array_equal(np.asarray(got["any_mism"][sl]),
                                      view.any_mism)
        np.testing.assert_array_equal(np.asarray(got["m_log_bq"][sl]),
                                      view.m_log_bq)
        nind = np.concatenate([view.n_indel_entries_row(h)
                               for h in range(len(haps))])
        np.testing.assert_array_equal(np.asarray(got["n_ind"][sl]), nind)
        offset += B
