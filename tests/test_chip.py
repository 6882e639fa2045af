"""Card-only tests (marker "chip"): the CUDA build of the fused DP kernel
on the GPU.  They skip on a host without a GPU; chip_smoke.py runs them
on the card with
    DINDEL_TESTS_ON_CHIP=1 python -m pytest -m chip tests/test_chip.py"""

import numpy as np
import pytest
import jax.numpy as jnp

from dindel_tpu.config import ObservationModelParameters, Parameters
from dindel_tpu.hmm.batch import pack_pairs, _dp_xla
from dindel_tpu.hmm.fused import dp_fused, expand_bt_codes
from dindel_tpu.parallel.mesh import synth_windows

pytestmark = pytest.mark.chip

KEYS = ["hap_len", "read_len", "b_mid", "read_codes", "hap_codes",
        "eq", "uq", "lpe", "lpn", "lpeV", "lpnV"]


@pytest.mark.parametrize("shape", [(8, 96, 160, 100, 1),
                                   (5, 40, 300, 150, 2)])
def test_cuda_kernel_matches_xla(gpu, shape):
    nh, nr, H, L, seed = shape
    params = ObservationModelParameters()
    (haps, reads, hs), = synth_windows(1, nh=nh, nr=nr, H=H, L=L, seed=seed)
    pk = pack_pairs(haps, reads, hs, params, dtype=np.float32)
    args = [jnp.asarray(pk[k]) for k in KEYS] + [jnp.asarray(pk["scalars"])]
    a1, b1, f1, g1 = [np.asarray(x) for x in _dp_xla(
        pk["H_pad"], pk["L_pad"], pk["numT"], *args)]
    a2, b2, f2c, g2c = [np.asarray(x) for x in dp_fused(
        pk["H_pad"], pk["L_pad"], pk["numT"], *args)]
    f2, g2 = expand_bt_codes(f2c, g2c, pk["hap_len"], pk["H_pad"],
                             pk["numT"])
    r = np.arange(pk["L_pad"] - 1)[:, None, None]
    bm = np.asarray(pk["b_mid"])[None, :, None]
    assert np.array_equal(a1, a2)
    assert np.array_equal(b1, b2)
    assert ((f1.astype(np.int32) != f2) & (r < bm)).sum() == 0
    assert ((g1.astype(np.int32) != g2) & (r >= bm)).sum() == 0


def test_engine_fused_matches_xla_on_card(gpu, tmp_path):
    from dindel_tpu.engine.batched import BatchedWindowEngine
    from dindel_tpu.engine.candidates import get_candidates
    from dindel_tpu.pipeline.windows import make_windows
    from dindel_tpu.sim import PlantedVariant, SimConfig, simulate

    variants = [PlantedVariant(pos=600 + 500 * i, var=v, genotype=1)
                for i, v in enumerate(["-ACG", "+TT", "-C", "+GAT"])]
    cfg = SimConfig(ref_len=2800, coverage=20, read_len=100)
    fa, bam = simulate(str(tmp_path / "sim"), variants, cfg, seed=9)
    var_file, _ = get_candidates(bam, str(tmp_path / "cand"), fa)
    win = make_windows(var_file, str(tmp_path / "win"))[0]
    outs = {}
    for impl in ("xla", "fused"):
        params = Parameters()
        params.do_diploid = True
        params.file_name = str(tmp_path / impl)
        eng = BatchedWindowEngine([bam], fa, params, batch_windows=8,
                                  dp_impl=impl, dtype=np.float32)
        glf = str(tmp_path / f"{impl}.glf.txt")
        eng.detect_indels(win, glf)
        assert eng.stats.windows_ok >= 3, eng.stats.error_messages
        assert eng.stats.stage_seconds.get("slab_rescues", 0) == 0
        eng.close()
        outs[impl] = open(glf).read()
    assert "dip.map" in outs["xla"]
    assert outs["xla"] == outs["fused"]
