#!/usr/bin/env python
"""Host-side profile of the batched engine on CPU: where does the
windows/s wall time go when the device phase is cheap (XLA CPU)?

Usage: python tools/profile_host.py [n_variants] [coverage] [sortby]
Prints cProfile tops for a warm detect_indels pass.
"""
import cProfile
import io
import pstats
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax

jax.config.update("jax_platforms", "cpu")
from dindel_tpu import compile_cache  # noqa: E402

compile_cache.enable("cpu")

import numpy as np
from dindel_tpu.config import Parameters
from dindel_tpu.engine.candidates import get_candidates
from dindel_tpu.engine.batched import BatchedWindowEngine
from dindel_tpu.pipeline.windows import make_windows
from dindel_tpu.sim import PlantedVariant, SimConfig, simulate


def main():
    n_var = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    coverage = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    sortby = sys.argv[3] if len(sys.argv) > 3 else "cumulative"
    rng = np.random.RandomState(7)
    spacing = 900
    ref_len = (n_var + 2) * spacing
    variants = []
    for i in range(n_var):
        pos = (i + 1) * spacing
        kind = rng.randint(3)
        if kind == 0:
            var = "-" + "ACGT"[rng.randint(4)] * rng.randint(1, 4)
        elif kind == 1:
            var = "+" + "".join("ACGT"[rng.randint(4)]
                                for _ in range(rng.randint(1, 4)))
        else:
            var = "-AC"
        variants.append(PlantedVariant(pos=pos, var=var,
                                       genotype=1 + rng.randint(2)))
    d = tempfile.mkdtemp(prefix="profhost")
    cfg = SimConfig(ref_len=ref_len, coverage=coverage, read_len=100)
    fa, bam = simulate(str(Path(d) / "sim"), variants, cfg, seed=3)
    var_file, _ = get_candidates(bam, str(Path(d) / "cand"), fa)
    win_files = make_windows(var_file, str(Path(d) / "win"))

    params = Parameters()
    params.do_diploid = True
    params.file_name = str(Path(d) / "out")
    eng = BatchedWindowEngine([bam], fa, params, batch_windows=64,
                              max_pairs_per_slab=8192, dp_impl="xla",
                              dtype=np.float32)
    # warm pass (compiles)
    for wf in win_files:
        eng.detect_indels(wf, str(Path(d) / "out.glf.txt"))

    from dindel_tpu.engine.stats import RunStats
    eng.stats = RunStats()
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    for wf in win_files:
        eng.detect_indels(wf, str(Path(d) / "out.glf.txt"))
    pr.disable()
    dt = time.perf_counter() - t0
    s = eng.stats.summary()
    eng.close()
    print(f"warm: {s['windows_ok']} windows in {dt:.2f}s = "
          f"{s['windows_ok']/dt:.1f} win/s")
    print("stages:", {k: round(v, 3)
                      for k, v in s.get("stage_seconds", {}).items()})
    out = io.StringIO()
    ps = pstats.Stats(pr, stream=out).sort_stats(sortby)
    ps.print_stats(45)
    print(out.getvalue())


if __name__ == "__main__":
    main()
