"""Scale-out driver: windows data-parallel across processes/hosts.

The reference's scale-out model is "run one dindel process per window
file on a cluster, then merge the GLF file list"
(makeWindows.py:46-54, mergeOutputDiploid.py:250-268).  This driver
automates the same model:

- single host: a process pool over window files, each worker running the
  (batched) window engine; per-shard GLF outputs are merged in window
  order, preserving the reference's restartability property (a shard is
  the checkpoint granularity — rerun a file, rerun its windows).  On a
  GPU host each worker is pinned to a card of its own (a JAX process
  reserves most of a card's memory, so two cannot share one);
- multi host: call run_shards with this host's slice of the window files
  (e.g. files[host_id::num_hosts] under jax.distributed); every host
  writes its own GLF shards and host 0 merges, exactly like the
  list-of-GLF-files contract of the merge scripts.
"""

from __future__ import annotations

import os
import subprocess
from multiprocessing import get_context
from typing import List, Optional

from ..config import Parameters
from ..model import LibraryCollection


def _run_one(args):
    (window_file, bam_paths, fasta_path, params, lib_file, backend,
     out_prefix) = args
    # imports inside the worker keep fork-safety with jax
    from .. import compile_cache
    from ..engine.batched import BatchedWindowEngine
    import numpy as np
    compile_cache.enable()
    libraries = LibraryCollection()
    if lib_file:
        # NB: obs_params.map_unmapped_reads (the insert-size positional
        # prior) stays off — dead code in the reference binary
        # (DInDel.cpp:3979-3986); enable via Parameters explicitly
        params.map_unmapped_reads = True
        libraries.add_from_file(lib_file)
    params.file_name = out_prefix
    import jax
    dp_impl = "fused" if backend == "fused" else "xla"
    dtype = (np.float64 if dp_impl == "xla" and jax.config.jax_enable_x64
             else np.float32)
    eng = BatchedWindowEngine([*bam_paths], fasta_path, params, libraries,
                              dp_impl=dp_impl, dtype=dtype)
    glf_path = out_prefix + ".glf.txt"
    eng.detect_indels(window_file, glf_path)
    stats = eng.stats.summary()
    eng.close()
    return glf_path, stats


def visible_cards() -> int:
    """Number of NVIDIA GPUs on this host (0 where there is none), read
    without starting JAX: the parent of a worker pool must stay off the
    cards."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=index",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return 0
    n = len(r.stdout.split()) if r.returncode == 0 else 0
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if n and vis is not None:
        n = min(n, len([c for c in vis.split(",") if c.strip()]))
    return n


def _pin_card(queue) -> None:
    """Pool initializer: give this worker one card before JAX starts."""
    card = queue.get()
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis:
        card = vis.split(",")[int(card)].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = str(card)


def run_shards(window_files: List[str], bam_paths: List[str],
               fasta_path: str, params: Parameters, output_prefix: str,
               lib_file: Optional[str] = None, backend: str = "xla",
               num_workers: int = 0):
    """Run every window file, in parallel when num_workers > 1 (one card
    per worker on a GPU host; more workers than cards are refused).
    Returns (glf_paths in window order, list of per-shard stats)."""
    jobs = []
    for i, wf in enumerate(window_files):
        jobs.append((wf, bam_paths, fasta_path, params, lib_file, backend,
                     f"{output_prefix}.shard{i}"))
    if num_workers and num_workers > 1 and len(jobs) > 1:
        ctx = get_context("spawn")  # fork is unsafe after jax init
        cards = visible_cards()
        init, initargs = None, ()
        if cards:
            if num_workers > cards:
                raise ValueError(f"{num_workers} workers but {cards} GPUs: "
                                 "each worker needs a card of its own")
            queue = ctx.Queue()
            for c in range(num_workers):
                queue.put(c)
            init, initargs = _pin_card, (queue,)
        with ctx.Pool(num_workers, initializer=init,
                      initargs=initargs) as pool:
            results = pool.map(_run_one, jobs)
    else:
        results = [_run_one(j) for j in jobs]
    glf_paths = [r[0] for r in results]
    stats = [r[1] for r in results]
    # shard-consistency check (SURVEY.md §5): every window of every input
    # file is processed exactly once — the distributed-era analogue of the
    # reference's duplicate-read buffer check
    for wf, st in zip(window_files, stats):
        with open(wf) as f:
            n_windows = sum(1 for line in f if line.strip())
        if st.get("windows_total") != n_windows:
            raise RuntimeError(
                f"shard consistency: {wf} has {n_windows} windows but the "
                f"worker processed {st.get('windows_total')}")
    return glf_paths, stats


def run_and_merge_diploid(window_files: List[str], bam_paths: List[str],
                          fasta_path: str, params: Parameters,
                          output_prefix: str, vcf_path: str,
                          sample_id: str = "SAMPLE",
                          num_workers: int = 0, backend: str = "xla"):
    """Full diploid pipeline tail: sharded calling + ordered VCF merge."""
    from .merge_diploid import merge_output_diploid
    params.do_diploid = True
    glf_paths, stats = run_shards(window_files, bam_paths, fasta_path,
                                  params, output_prefix,
                                  num_workers=num_workers, backend=backend)
    merge_output_diploid(glf_paths, vcf_path, fasta_path, sample_id=sample_id)
    return glf_paths, stats
