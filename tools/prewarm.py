#!/usr/bin/env python
"""Prewarm the persistent XLA compile cache for the production shape
buckets (VERDICT r4 item 9: cold-start management).

Every distinct quantized slab shape costs a one-time XLA compile (the
fused slab program dominates).  The persistent compile cache
(dindel_tpu/compile_cache.py: JAX_COMPILATION_CACHE_DIR, else .jax_cache/
in the checkout) keeps them: a fresh process on a warmed cache pays only
per-key tracing.

This tool deliberately exercises the standard buckets so a fresh cache
volume is warmed once, off the critical path:
  - the batched diploid engine at the benchmark geometry (W=128 batches,
    100 bp reads, 24k-pair slabs) plus the partial-batch W buckets;
  - the pooled engine (adds the device-EM program);
  - the plain chained kernel (bench.py geometry).

Usage: python tools/prewarm.py   (run on the GPU host; reruns are cheap)
"""

import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main():
    env = dict(os.environ)
    t0 = time.time()
    for mode, n in (("dip", 136), ("pooled", 136), ("dip", 40)):
        e = dict(env)
        e["BENCH_MODE"] = mode
        print(f"[prewarm] bench_windows {n} ({mode})", flush=True)
        subprocess.run([sys.executable,
                        str(REPO / "tools" / "bench_windows.py"), str(n)],
                       env=e, timeout=1800)
    sys.path.insert(0, str(REPO))
    from dindel_tpu.compile_cache import CHECKOUT_CACHE
    print(f"[prewarm] done in {time.time() - t0:.0f}s; cache at "
          f"{os.environ.get('JAX_COMPILATION_CACHE_DIR', CHECKOUT_CACHE)}")


if __name__ == "__main__":
    main()
