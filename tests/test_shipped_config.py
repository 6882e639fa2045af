"""Execute the ``--hmmBackend fused`` engine configuration in CI: the
fused DP kernel (its host build on CPU), the argmax finish
(exact_ties=False), float32, device-side calling — and assert GLF
equality with the XLA f32 engine."""

import numpy as np
import pytest

from dindel_tpu.config import Parameters
from dindel_tpu.engine.batched import BatchedWindowEngine
from dindel_tpu.engine.candidates import get_candidates
from dindel_tpu.pipeline.windows import make_windows
from dindel_tpu.sim import PlantedVariant, SimConfig, simulate


def test_engine_fused_matches_xla_f32(tmp_path):
    variants = [PlantedVariant(pos=600, var="-ACG", genotype=1),
                PlantedVariant(pos=1400, var="+TT", genotype=2)]
    cfg = SimConfig(ref_len=2000, coverage=12, read_len=50)
    fa, bam = simulate(str(tmp_path / "sim"), variants, cfg, seed=9)
    var_file, _ = get_candidates(bam, str(tmp_path / "cand"), fa)
    win_files = make_windows(var_file, str(tmp_path / "win"))

    outs = {}
    for name, impl in (("xla", "xla"), ("fused", "fused")):
        params = Parameters()
        params.do_diploid = True
        params.file_name = str(tmp_path / name)
        eng = BatchedWindowEngine([bam], fa, params, batch_windows=8,
                                  dp_impl=impl, dtype=np.float32)
        glf = str(tmp_path / f"{name}.glf.txt")
        eng.detect_indels(win_files[0], glf)
        assert eng.stats.windows_ok >= 2, eng.stats.error_messages
        # the comparison is vacuous if the device path crashed and the
        # per-window rescue recomputed everything through XLA
        assert eng.stats.stage_seconds.get("slab_rescues", 0) == 0
        eng.close()
        outs[name] = open(glf).read()
    assert "dip.map" in outs["xla"]
    assert outs["xla"] == outs["fused"]


def test_golden_pipeline_fused(tmp_path):
    """The golden diploid pipeline driven through the fused-kernel f32
    engine still produces the same calls as the pinned golden VCF's
    sites (engine-level smoke of the full flag combination users get
    with --engine batched --hmmBackend fused)."""
    from dindel_tpu.pipeline.merge_diploid import merge_output_diploid

    variants = [PlantedVariant(pos=700, var="-ACG", genotype=1)]
    cfg = SimConfig(ref_len=2100, coverage=25, read_len=75)
    fa, bam = simulate(str(tmp_path / "sim"), variants, cfg, seed=11)
    var_file, _ = get_candidates(bam, str(tmp_path / "cand"), fa)
    win_files = make_windows(var_file, str(tmp_path / "win"))
    params = Parameters()
    params.do_diploid = True
    params.file_name = str(tmp_path / "out")
    eng = BatchedWindowEngine([bam], fa, params, dp_impl="fused",
                              dtype=np.float32)
    glf = str(tmp_path / "out.glf.txt")
    eng.detect_indels(win_files[0], glf)
    assert eng.stats.stage_seconds.get("slab_rescues", 0) == 0
    eng.close()
    vcf = str(tmp_path / "calls.vcf")
    merge_output_diploid([glf], vcf, fa)
    recs = [l.split("\t") for l in open(vcf) if not l.startswith("#")]
    dels = [r for r in recs if len(r[3]) > len(r[4])]
    assert dels and (int(dels[0][1]), dels[0][3], dels[0][4],
                     dels[0][9].split(":")[0]) == (3128, "AGGG", "A", "0/1")
