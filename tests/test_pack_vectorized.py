"""Vectorized pack_pairs must be byte-identical to the per-pair
reference loop (_pack_pairs_ref), including the unmapped-mate
insert-size prior path."""

import numpy as np
import pytest

from dindel_tpu.config import ObservationModelParameters
from dindel_tpu.hmm.batch import pack_pairs, _pack_pairs_ref
from dindel_tpu.model import Library, LibraryCollection
from dindel_tpu.parallel.mesh import synth_windows


def _compare(pk_ref, pk_new):
    assert pk_ref.keys() == pk_new.keys()
    for k in pk_ref:
        a, b = pk_ref[k], pk_new[k]
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, k
            assert np.array_equal(a, b), k
        else:
            assert a == b, k


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pack_identical(dtype):
    params = ObservationModelParameters()
    (haps, reads, hs), = synth_windows(1, nh=4, nr=40, H=90, L=50, seed=5)
    # perturb read attributes for coverage of b_mid branches
    import random
    rng = random.Random(2)
    for r in reads:
        r.map_qual = rng.choice([0.5, 0.99, 1.0 - 1e-16])
        r.pos_stat_first += rng.randrange(-200, 200)
        if rng.random() < 0.1:
            r.is_unmapped = True
    pk_ref = _pack_pairs_ref(haps, reads, hs, params, dtype=dtype)
    pk_new = pack_pairs(haps, reads, hs, params, dtype=dtype)
    _compare(pk_ref, pk_new)


def test_pack_identical_explicit_layout():
    """Caller-chosen H_pad/L_pad (as the engine's slab buckets pass)."""
    params = ObservationModelParameters()
    (haps, reads, hs), = synth_windows(1, nh=3, nr=17, H=100, L=60, seed=8)
    pk_ref = _pack_pairs_ref(haps, reads, hs, params, dtype=np.float32,
                             H_pad=126, L_pad=64)
    pk_new = pack_pairs(haps, reads, hs, params, dtype=np.float32,
                        H_pad=126, L_pad=64)
    _compare(pk_ref, pk_new)


def test_pack_identical_unmapped_mates():
    params = ObservationModelParameters()
    params.map_unmapped_reads = True
    (haps, reads, hs), = synth_windows(1, nh=2, nr=20, H=80, L=40, seed=6)
    libs = LibraryCollection()
    rng = np.random.RandomState(0)
    counts = rng.poisson(5, 600).astype(np.float64) + 1
    libs["libA"] = Library(counts)
    import random
    prng = random.Random(3)
    for i, r in enumerate(reads):
        if i % 2 == 0:
            r.is_paired = True
            r.mate_is_unmapped = False
            r.mate_len = 75
            r.mate_pos = int(r.pos_stat_first) + prng.randrange(100, 300)
            r.same_tid_as_mate = True
            if i % 4 == 0:
                r.mate_is_reverse = True
            r.library = libs["libA"]
    pk_ref = _pack_pairs_ref(haps, reads, hs, params, dtype=np.float64)
    pk_new = pack_pairs(haps, reads, hs, params, dtype=np.float64)
    _compare(pk_ref, pk_new)


def test_compact_matches_dense():
    """Compact table packing, expanded on host AND through the device
    path, must equal the dense pack_pairs bit-for-bit."""
    from dindel_tpu.hmm.batch import (pack_pairs_compact, merge_compact,
                                      expand_compact_host, run_packed,
                                      run_packed_compact)
    import random
    params = ObservationModelParameters()
    for dtype in (np.float64, np.float32):
        (haps, reads, hs), = synth_windows(1, nh=4, nr=30, H=90, L=50,
                                           seed=5)
        rng = random.Random(2)
        for r in reads:
            r.map_qual = rng.choice([0.5, 0.99, 1.0 - 1e-16])
        dense = pack_pairs(haps, reads, hs, params, dtype=dtype)
        comp = pack_pairs_compact(haps, reads, hs, params, dtype=dtype,
                                  H_pad=dense["H_pad"],
                                  L_pad=dense["L_pad"])
        exp = expand_compact_host(comp)
        for k in ("read_codes", "eq", "uq", "hap_codes", "lpe", "lpn",
                  "lpeV", "lpnV", "prior_rmq", "prior_hmq", "hap_len",
                  "read_len", "b_mid"):
            assert np.array_equal(dense[k], exp[k]), (dtype, k)
        a = [np.asarray(x) for x in run_packed(dense, "xla")]
        b = [np.asarray(x) for x in run_packed_compact(comp, "xla")]
        for nm, x, y in zip(("ll", "oh", "ohh", "llo", "llon", "ms"), a, b):
            assert np.array_equal(x, y), (dtype, nm)


def test_merge_compact_two_windows():
    """merge_compact over two windows equals per-window runs."""
    from dindel_tpu.hmm.batch import (pack_pairs_compact, merge_compact,
                                      run_packed_compact)
    params = ObservationModelParameters()
    ws = synth_windows(2, nh=3, nr=12, H=80, L=40, seed=4)
    pks = [pack_pairs_compact(h, r, s, params, dtype=np.float64,
                              H_pad=96, L_pad=48) for h, r, s in ws]
    merged = merge_compact(pks)
    got = [np.asarray(x) for x in run_packed_compact(merged, "xla")]
    off = 0
    for pk in pks:
        B = pk["hap_len"].shape[0]
        want = [np.asarray(x) for x in run_packed_compact(pk, "xla")]
        for nm, w, g in zip(("ll", "oh", "ohh", "llo", "llon", "ms"),
                            want, got):
            assert np.array_equal(w, g[off:off + B]), nm
        off += B
