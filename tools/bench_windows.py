#!/usr/bin/env python
"""End-to-end realignment throughput: windows/sec through the full
BatchedWindowEngine pipeline (BAM fetch -> hap gen -> NW -> pair-HMM on
device -> diploid calling -> GLF) on a synthetic dataset.

Usage: python tools/bench_windows.py [n_variants] [coverage]
Runs on one NVIDIA GPU with the fused DP kernel and fails where JAX
finds no GPU.  This is the BASELINE.json "windows/sec" metric at 1
card; per-stage timings from RunStats show where the time goes (see
PERF.md).
"""
import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax

from dindel_tpu import compile_cache

compile_cache.enable()

import numpy as np
from dindel_tpu.config import Parameters
from dindel_tpu.engine.candidates import get_candidates
from dindel_tpu.engine.batched import BatchedWindowEngine
from dindel_tpu.pipeline.windows import make_windows
from dindel_tpu.sim import PlantedVariant, SimConfig, simulate


def main():
    n_var = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    coverage = int(sys.argv[2]) if len(sys.argv) > 2 else 30
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
    d = tempfile.mkdtemp(prefix="benchwin")
    cfg = SimConfig(ref_len=ref_len, coverage=coverage, read_len=100)
    t0 = time.perf_counter()
    fa, bam = simulate(str(Path(d) / "sim"), variants, cfg, seed=3)
    print(f"simulated {ref_len}bp x{coverage} in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    var_file, _ = get_candidates(bam, str(Path(d) / "cand"), fa)
    win_files = make_windows(var_file, str(Path(d) / "win"))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_windows measures a GPU; JAX found "
                         f"{dev.platform}")
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    device = dict(platform=dev.platform, device_kind=dev.device_kind,
                  device_count=len(jax.devices()), card=card)

    # Multi-process host staging mode (parallel/hostshard.py):
    # BENCH_STAGE_PROCS=N shards the windows into ~N*3 files, runs N
    # staging processes feeding this process's device, and reports
    # windows/s over the in-children span (excludes interpreter spawn).
    procs = int(os.environ.get("BENCH_STAGE_PROCS", "0"))
    if procs:
        from dindel_tpu.parallel.hostshard import run_hostshard
        win_files = make_windows(var_file, str(Path(d) / "winsh"),
                                 variants_per_file=max(
                                     4, n_var // (procs * 3)))
        params = Parameters()
        if os.environ.get("BENCH_MODE", "dip") == "pooled":
            params.estimate_hap_freqs = True
        else:
            params.do_diploid = True
        params.file_name = str(Path(d) / "out")
        kw = dict(
            batch_windows=int(os.environ.get("BENCH_BATCH_WINDOWS", "128")),
            max_pairs_per_slab=int(os.environ.get("BENCH_MAX_PAIRS", "24576")),
            dp_impl="fused", dtype=np.float32)
        repeats = int(os.environ.get("BENCH_REPEATS", "3"))
        t0 = time.perf_counter()
        st: dict = {}
        run_hostshard([bam], fa, params, win_files,
                      str(Path(d) / "out.glf.txt"), n_procs=procs,
                      engine_kw=kw, repeats=repeats, stats_out=st)
        wall = time.perf_counter() - t0
        span = st["t_end"] - st["t_start"]
        warm = (st["warm_windows"] / st["warm_span_s"]
                if st.get("warm_span_s") else None)
        print(json.dumps({
            "metric": "windows_per_sec_hostshard",
            "value": warm if warm is not None else st["windows_ok"] / span,
            "unit": "windows/s",
            "stage_procs": procs,
            "repeats": repeats,
            "windows_ok": st["windows_ok"],
            "span_s": round(span, 3),
            "warm_span_s": round(st.get("warm_span_s", 0.0), 3),
            "warm_windows": st.get("warm_windows"),
            "cold_incl_compile_windows_per_sec":
                round(st["windows_ok"] / span, 3),
            "wall_incl_spawn_s": round(wall, 3),
            **device,
        }))
        return

    params = Parameters()
    # BENCH_MODE=pooled benches the VB-EM caller path (--doPooled)
    mode = os.environ.get("BENCH_MODE", "dip")
    if mode == "pooled":
        params.estimate_hap_freqs = True
    else:
        params.do_diploid = True
    params.file_name = str(Path(d) / "out")
    eng = BatchedWindowEngine(
        [bam], fa, params,
        batch_windows=int(os.environ.get("BENCH_BATCH_WINDOWS", "128")),
        max_pairs_per_slab=int(os.environ.get("BENCH_MAX_PAIRS", "24576")),
        dp_impl="fused", dtype=np.float32)
    # pass 1 (cold): includes one-time XLA compiles for each quantized
    # shape bucket (persisted in the jax compilation cache).  The warm
    # passes are the steady-state number.
    t0 = time.perf_counter()
    rows = []
    for wf in win_files:
        rows.extend(eng.detect_indels(wf, str(Path(d) / "out.glf.txt")))
    dt_cold = time.perf_counter() - t0
    n_ok = eng.stats.windows_ok

    from dindel_tpu.engine.stats import RunStats
    # best-of-N warm passes
    n_warm = int(os.environ.get("BENCH_WARM_PASSES", "2"))
    best = None
    for _ in range(n_warm):
        eng.stats = RunStats()
        t0 = time.perf_counter()
        rows = []
        for wf in win_files:
            rows.extend(eng.detect_indels(wf, str(Path(d) / "out.glf.txt")))
        dt_i = time.perf_counter() - t0
        if best is None or dt_i < best[0]:
            best = (dt_i, eng.stats.summary(), rows)
    dt, s, rows = best
    eng.close()
    print(json.dumps({
        "metric": "windows_per_sec",
        "mode": mode,
        "value": s["windows_ok"] / dt,
        "unit": "windows/s",
        "windows_ok": s["windows_ok"],
        "windows_error": s["windows_error"],
        "calls": len(rows),
        "wall_s": round(dt, 3),
        "cold_wall_s": round(dt_cold, 3),
        "cold_windows_per_sec": round(n_ok / dt_cold, 3),
        "stage_seconds": {k: round(v, 3)
                          for k, v in s.get("stage_seconds", {}).items()},
        **device,
    }))


if __name__ == "__main__":
    main()
