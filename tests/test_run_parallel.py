"""Sharded run driver: multiple window files -> per-shard GLFs -> merged
VCF, same calls as a single run."""

import jax
import pytest

jax.config.update("jax_enable_x64", True)

from dindel_tpu.config import Parameters
from dindel_tpu.engine.candidates import get_candidates
from dindel_tpu.pipeline.windows import make_windows
from dindel_tpu.pipeline.run_parallel import run_and_merge_diploid
from dindel_tpu.sim import PlantedVariant, SimConfig, simulate


def test_sharded_run_and_merge(tmp_path):
    variants = [PlantedVariant(pos=700, var="-ACG", genotype=1),
                PlantedVariant(pos=1700, var="-TT", genotype=2)]
    cfg = SimConfig(ref_len=2400, coverage=18, read_len=70)
    fa, bam = simulate(str(tmp_path / "sim"), variants, cfg, seed=4)
    var_file, _ = get_candidates(bam, str(tmp_path / "cand"), fa)
    # force one window per file -> several shards
    win_files = make_windows(var_file, str(tmp_path / "win"),
                             variants_per_file=-1)
    assert len(win_files) >= 2

    params = Parameters()
    vcf = str(tmp_path / "calls.vcf")
    glfs, stats = run_and_merge_diploid(
        win_files, [bam], fa, params, str(tmp_path / "run"), vcf,
        num_workers=1)
    assert len(glfs) == len(win_files)
    assert sum(s["windows_ok"] for s in stats) >= 2
    recs = [l for l in open(vcf) if not l.startswith("#")]
    assert len(recs) >= 2
    # position-ordered output
    poss = [int(l.split("\t")[1]) for l in recs]
    assert poss == sorted(poss)


def test_run_shards_refuses_more_workers_than_cards(monkeypatch, tmp_path):
    """On a GPU host every worker gets a card of its own: a JAX process
    reserves most of a card's memory, so a second one on it would fail."""
    from dindel_tpu.pipeline import run_parallel
    monkeypatch.setattr(run_parallel, "visible_cards", lambda: 2)
    with pytest.raises(ValueError, match="card of its own"):
        run_parallel.run_shards(["a", "b", "c", "d"], ["x.bam"], "x.fa",
                                Parameters(), str(tmp_path / "run"),
                                num_workers=4)


@pytest.mark.parametrize("visible,slot,want", [(None, 2, "2"),
                                               ("3,5", 1, "5")])
def test_pin_card_sets_visible_device(monkeypatch, visible, slot, want):
    from dindel_tpu.pipeline import run_parallel

    class Q:
        def get(self):
            return slot

    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    run_parallel._pin_card(Q())
    import os
    assert os.environ["CUDA_VISIBLE_DEVICES"] == want


def test_visible_cards_without_driver(monkeypatch):
    from dindel_tpu.pipeline import run_parallel

    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(run_parallel.subprocess, "run", missing)
    assert run_parallel.visible_cards() == 0
