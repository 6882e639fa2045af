#!/usr/bin/env python
"""Smoke run of the realignment engine on one NVIDIA GPU.

    python chip_smoke.py                 # one card, every phase below
    python chip_smoke.py --four-cards    # the multi-card phase only (4 cards)

Phases on one card, in order (any failure exits non-zero and prints no
"ok"):

  chip_tests  the card-only pytest tests (``-m chip``), in a child process
              that ends before this process opens the card;
  kernel      the fused DP kernel against the XLA DP (hmm/batch._dp_xla) in
              float32 with exact ties, at the kernel bench shape (8 haps x
              768 reads, 160 bp haps, 100 bp reads) and on one full engine
              slab (24576 pairs): alpha/beta bMid slices identical,
              backpointers identical on the rows _finish consumes, _finish
              outputs identical; both timed, chained on device;
  oracle      float32 log-likelihoods from the card against the float64
              NumPy oracle (hmm/reference.py) on 64 pairs;
  diploid     the user pipeline through the CLI entry points on a simulated
              deployment (one window file of one chromosome arm, 30x,
              100 bp reads, >= 384 windows): getCIGARindels -> makeWindows
              -> indels --doDiploid --engine batched (XLA DP and fused DP,
              GLF bytes must agree; timed cold, then warm in the order
              XLA, fused, fused, XLA) -> mergeOutputDiploid, scored against
              the simulator's planted indels;
  pooled      indels --doPooled --engine batched (device VB-EM).

--four-cards runs the same window files three ways and requires
byte-identical GLF: run_shards with one worker per card (this process
stays off the cards meanwhile), --engine batched --mesh 4x1, and one card.

The last stdout line is {"ok": true, "device": {...}} on success.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from dindel_tpu import compile_cache  # noqa: E402  (fails outside the repo)

PHASES = ("chip_tests", "kernel", "oracle", "diploid", "pooled")
N_WINDOWS = 384
# (windows, haps, reads, hap length, read length, seed) of the kernel
# comparisons: the kernel bench shape, and one full engine slab of
# 24576 pairs (the default --maxPairsPerSlab)
KERNEL_SHAPES = {"bench": (1, 8, 768, 160, 100, 1),
                 "slab": (32, 8, 96, 160, 100, 2)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError("nvidia-smi found no GPU")
    return r.stdout.strip()


def run_chip_tests() -> None:
    env = dict(os.environ, DINDEL_TESTS_ON_CHIP="1")
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "chip",
                        "-p", "no:cacheprovider", "tests/test_chip.py"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    log(f"chip_tests: rc={r.returncode} {tail}")
    if r.returncode != 0 or "passed" not in tail or "skipped" in tail:
        sys.stderr.write(r.stdout[-6000:] + r.stderr[-3000:])
        raise RuntimeError("card-only tests failed")


def require_gpu():
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found {devs[0].platform}")
    return devs


# ---------------------------------------------------------------- kernel
def _dense_slab(n_windows, nh, nr, H, L, seed):
    """A packed slab the way the engine builds one: compact tables merged
    across windows, padded to shape buckets, expanded on device."""
    import numpy as np
    import jax.numpy as jnp
    from dindel_tpu.config import ObservationModelParameters
    from dindel_tpu.hmm.batch import (_expand_compact, merge_compact,
                                      pack_pairs_compact, pad_compact,
                                      _round_up)
    from dindel_tpu.parallel.mesh import synth_windows

    params = ObservationModelParameters()
    wins = synth_windows(n_windows, nh=nh, nr=nr, H=H, L=L, seed=seed)
    H_pad = _round_up(max(len(h.seq) for w in wins for h in w[0]), 16)
    L_pad = _round_up(L, 16)
    pk = pad_compact(merge_compact([
        pack_pairs_compact(haps, reads, hs, params, np.float32,
                           H_pad=H_pad, L_pad=L_pad)
        for haps, reads, hs in wins]))
    (rc, eq, uq, hc, lpe, lpn, lpeV, lpnV, prr, prh, om) = _expand_compact(
        H_pad, L_pad, np.dtype(np.float32).str, *[jnp.asarray(pk[k]) for k in (
            "read_codes_r", "eq_r", "uq_r", "hap_codes_h", "lpe_h", "lpn_h",
            "lpeV_h", "lpnV_h", "hap_idx", "read_idx", "hap_len", "b_mid",
            "log_off_r", "log_on_r")],
        (pk["log_off_hmq"], pk["log_on_hmq"]),
        (pk["log_ins0"], pk["log_ins1"]))
    dp_args = (jnp.asarray(pk["hap_len"]), jnp.asarray(pk["read_len"]),
               jnp.asarray(pk["b_mid"]), rc, hc, eq, uq, lpe, lpn, lpeV,
               lpnV, jnp.asarray(pk["scalars"]))
    return dict(H_pad=H_pad, L_pad=L_pad, numT=pk["numT"], dp_args=dp_args,
                obs_mid=om, prior_rmq=prr, prior_hmq=prh, wins=wins,
                B=int(pk["hap_idx"].shape[0]))


def _compare(s):
    """Mismatch counts, reduced on device, between the fused DP and
    _dp_xla (+ the exact-ties _finish of each)."""
    import jax
    import jax.numpy as jnp
    from dindel_tpu.hmm.batch import _dp_xla, _finish
    from dindel_tpu.hmm.fused import dp_fused, expand_bt_codes

    H_pad, L_pad, numT = s["H_pad"], s["L_pad"], s["numT"]
    a = s["dp_args"]
    hap_len, read_len, b_mid = a[0], a[1], a[2]

    def fin(dp_out, codes):
        return _finish(H_pad, L_pad, b_mid, dp_out[0], dp_out[1],
                       s["obs_mid"], s["prior_rmq"], s["prior_hmq"],
                       dp_out[2], dp_out[3], exact_ties=True,
                       bt_codes=codes, numT=numT, hap_len=hap_len)

    @jax.jit
    def diff(ref, got):
        f2, g2 = expand_bt_codes(got[2], got[3], hap_len, H_pad, numT,
                                 xp=jnp)
        r = jnp.arange(L_pad - 1)[:, None, None]
        bm = b_mid[None, :, None]
        fr, fg = fin(ref, False), fin(got, True)
        valid = jnp.arange(L_pad)[None, :] < read_len[:, None]
        out = dict(
            alpha_mid=jnp.sum(ref[0] != got[0]),
            beta_mid=jnp.sum(ref[1] != got[1]),
            btf=jnp.sum((ref[2].astype(jnp.int32) != f2) & (r < bm)),
            btb=jnp.sum((ref[3].astype(jnp.int32) != g2) & (r >= bm)))
        for name, x, y in zip(("ll", "off_hap", "off_hap_hmq", "ll_off",
                               "ll_on"), fr[:5], fg[:5]):
            out[name] = jnp.sum(x != y)
        out["map_state"] = jnp.sum((fr[5] != fg[5]) & valid)
        return out

    ref = _dp_xla(H_pad, L_pad, numT, *a)
    got = dp_fused(H_pad, L_pad, numT, *a)
    return {k: int(v) for k, v in diff(ref, got).items()}


def _time_chain(s, impl, K=8, reps=3):
    """Seconds per DP + _finish, K evaluations chained on device (each
    iteration's eq input depends on the previous ll)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from dindel_tpu.hmm.batch import _finish, get_dp_impl

    H_pad, L_pad, numT = s["H_pad"], s["L_pad"], s["numT"]
    a = list(s["dp_args"])
    dp = get_dp_impl(impl)

    @jax.jit
    def chain(eq0):
        def body(eqc, _):
            args = list(a)
            args[5] = eqc
            amid, bmid, btf, btb = dp(H_pad, L_pad, numT, *args)
            out = _finish(H_pad, L_pad, args[2], amid, bmid, s["obs_mid"],
                          s["prior_rmq"], s["prior_hmq"], btf, btb,
                          exact_ties=False, bt_codes=impl == "fused",
                          numT=numT, hap_len=args[0])
            return eqc + out[0][0] * 0.0, None
        eqc, _ = lax.scan(body, eq0, None, length=K)
        return jnp.sum(eqc)

    chain(a[5]).block_until_ready()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        chain(a[5]).block_until_ready()
        ts.append((time.perf_counter() - t0) / K)
    return sorted(ts)[len(ts) // 2]


def phase_kernel(rec):
    import jax
    slabs = {k: _dense_slab(*v) for k, v in KERNEL_SHAPES.items()}
    for name, s in slabs.items():
        mm = _compare(s)
        log(f"kernel_vs_xla[{name}] pairs={s['B']} H_pad={s['H_pad']} "
            f"L_pad={s['L_pad']} mismatches={json.dumps(mm)}")
        if any(mm.values()):
            raise RuntimeError(f"fused DP differs from _dp_xla ({name})")
        rec[f"kernel_{name}_mismatches"] = 0
    for name, s in slabs.items():
        # alternate x, f, f, x so drift hits both alike
        t = {"xla": [], "fused": []}
        for impl in ("xla", "fused", "fused", "xla"):
            t[impl].append(_time_chain(s, impl))
        for impl in t:
            rec[f"dp_finish_s_{name}_{impl}"] = min(t[impl])
        log(f"dp+finish seconds/call [{name}]: xla {t['xla']} "
            f"fused {t['fused']}")
    dev = jax.devices()[0]
    rec["peak_bytes_after_kernel"] = (dev.memory_stats() or {}).get(
        "peak_bytes_in_use")
    return slabs["bench"]


def phase_oracle(rec, bench):
    """float32 fused path vs the float64 NumPy oracle on 64 pairs."""
    import numpy as np
    from dindel_tpu.config import ObservationModelParameters
    from dindel_tpu.hmm.batch import _finish
    from dindel_tpu.hmm.fused import dp_fused
    from dindel_tpu.hmm.reference import pair_hmm_single

    s = bench
    a = s["dp_args"]
    out = dp_fused(s["H_pad"], s["L_pad"], s["numT"], *a)
    ll = np.asarray(_finish(s["H_pad"], s["L_pad"], a[2], out[0], out[1],
                            s["obs_mid"], s["prior_rmq"], s["prior_hmq"],
                            out[2], out[3], exact_ties=False, bt_codes=True,
                            numT=s["numT"], hap_len=a[0])[0])
    haps, reads, hs = s["wins"][0]
    params = ObservationModelParameters()
    rng = np.random.RandomState(5)
    worst = 0.0
    for i in rng.choice(len(haps) * len(reads), 64, replace=False):
        hi, ri = divmod(int(i), len(reads))
        want = pair_hmm_single(haps[hi], reads[ri], hs, params).ll
        err = abs(float(ll[i]) - want)
        worst = max(worst, err / max(1.0, abs(want)))
    rec["oracle_max_rel_err"] = worst
    log(f"oracle: max |ll_f32 - ll_f64| / max(1, |ll|) over 64 pairs = "
        f"{worst:.3g} (limit {ORACLE_TOL:g})")
    if not worst <= ORACLE_TOL:
        raise RuntimeError("float32 log-likelihoods drift from the oracle")


# float32 keeps 24 bits: each of the ~100 DP steps rounds once at |ll| up to
# a few hundred, so the accumulated error is ~100 ulp(|ll|) ~ 1e-5 relative
ORACLE_TOL = 1e-4


# ---------------------------------------------------------------- pipeline
def simulate_deployment(d: Path, n_var: int, seed: int):
    """One chromosome arm's window file: heterozygous indels every 900 bp,
    30x, 100 bp paired reads.  Returns (fasta, bam, planted)."""
    import numpy as np
    from dindel_tpu.sim import PlantedVariant, SimConfig, simulate

    rng = np.random.RandomState(seed)
    spacing = 900
    variants = []
    for i in range(n_var):
        kind = rng.randint(3)
        if kind == 0:
            var = "-" + "ACGT"[rng.randint(4)] * rng.randint(1, 4)
        elif kind == 1:
            var = "+" + "".join("ACGT"[rng.randint(4)]
                                for _ in range(rng.randint(1, 4)))
        else:
            var = "-" + "".join("ACGT"[rng.randint(4)]
                                for _ in range(rng.randint(2, 6)))
        variants.append(PlantedVariant(pos=(i + 1) * spacing, var=var,
                                       genotype=1))
    cfg = SimConfig(ref_len=(n_var + 2) * spacing, coverage=30, read_len=100)
    fa, bam = simulate(str(d / "sim"), variants, cfg, seed=seed)
    return fa, bam, [(v.pos + cfg.start_pad, v.var) for v in variants]


def cli(*argv):
    from dindel_tpu import cli as _cli
    rc = _cli.main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"dindel_tpu {' '.join(map(str, argv))}: rc {rc}")


def indels(bam, fa, win, out, *extra):
    from dindel_tpu import cli as _cli
    args = _cli.build_parser().parse_args(
        ["--analysis", "indels", "--bamFile", bam, "--ref", fa,
         "--varFile", win, "--outputFile", out, "--engine", "batched",
         *extra])
    t0 = time.perf_counter()
    st = _cli.run_indels(args)
    wall = time.perf_counter() - t0
    rescues = st["stage_seconds"].get("slab_rescues", 0)
    if rescues:
        raise RuntimeError(f"{rescues} slab rescues: the device phase failed")
    if st["windows_ok"] < N_WINDOWS:
        raise RuntimeError(f"only {st['windows_ok']} windows ok")
    return wall, st


def score_calls(vcf: str, planted):
    """Recall of planted indels among the VCF records (same kind and
    length within 25 bp, each record used once) and the share of matched
    records genotyped 0/1 (every planted indel is heterozygous)."""
    recs = []
    for line in open(vcf):
        if line.startswith("#"):
            continue
        f = line.rstrip("\n").split("\t")
        recs.append((int(f[1]), len(f[3]) - len(f[4]), f[9].split(":")[0]))
    used = set()
    hit = gt_ok = 0
    for pos, var in planted:
        dl = (len(var) - 1) * (1 if var[0] == "-" else -1)
        for k, (p, d, gt) in enumerate(recs):
            if k not in used and d == dl and abs(p - pos) <= 25:
                used.add(k)
                hit += 1
                gt_ok += gt in ("0/1", "1/0")
                break
    return hit / len(planted), (gt_ok / hit if hit else 0.0), len(recs)


def phase_diploid(rec, d: Path, seed: int, warm_pairs: int):
    fa, bam, planted = simulate_deployment(d, N_WINDOWS + 16, seed)
    cli("--analysis", "getCIGARindels", "--bamFile", bam, "--ref", fa,
        "--outputFile", d / "cand")
    cli("--analysis", "makeWindows", "--inputVarFile",
        d / "cand.variants.txt", "--windowFilePrefix", d / "win")
    win = str(d / "win.1.txt")
    # cold (compiles) once each, then warm pairs in alternating order
    runs = [("xla", "cold"), ("fused", "cold")]
    for i in range(warm_pairs):
        pair = [("xla", "warm"), ("fused", "warm")]
        runs += pair if i % 2 == 0 else pair[::-1]
    glf = {}
    for impl, kind in runs:
        out = str(d / f"dip_{impl}")
        wall, st = indels(bam, fa, win, out, "--doDiploid", "--hmmBackend",
                          "jax" if impl == "xla" else "fused")
        rec.setdefault(f"diploid_{kind}_wall_s_{impl}", []).append(wall)
        rec["windows_ok"] = st["windows_ok"]
        glf.setdefault(impl, open(out + ".glf.txt", "rb").read())
        stages = {k: round(v, 3) for k, v in st["stage_seconds"].items()}
        log(f"diploid[{impl} {kind}]: wall {wall:.3f} s, windows_ok "
            f"{st['windows_ok']}, slab_rescues 0, windows/s "
            f"{st['windows_ok'] / wall:.2f}, stages {json.dumps(stages)}")
    if glf["xla"] != glf["fused"]:
        raise RuntimeError("GLF bytes differ between the XLA and fused DP")
    log(f"diploid GLF bytes identical across DP implementations "
        f"({len(glf['xla'])} bytes)")
    (d / "glfs.txt").write_text(str(d / "dip_fused.glf.txt") + "\n")
    cli("--analysis", "mergeOutputDiploid", "--inputFiles", d / "glfs.txt",
        "--ref", fa, "--outputFile", d / "calls.vcf")
    recall, gt, n = score_calls(str(d / "calls.vcf"), planted)
    rec.update(planted=len(planted), vcf_records=n, recall=recall,
               genotype_agreement=gt)
    log(f"calls: {n} VCF records, planted-indel recall {recall:.4f}, "
        f"genotype agreement {gt:.4f}")
    if recall < 0.9 or gt < 0.9:
        raise RuntimeError("calls disagree with the simulator's truth")
    return fa, bam, win


def phase_pooled(rec, d: Path, fa, bam, win):
    wall, st = indels(bam, fa, win, str(d / "pooled"), "--doPooled")
    em = st["stage_seconds"].get("device_em", 0.0)
    log(f"pooled: wall {wall:.3f} s, windows_ok {st['windows_ok']}, "
        f"slab_rescues 0, device_em {em:.3f} s")
    if not em:
        raise RuntimeError("the pooled run did not reach the device EM")
    rec["pooled_wall_s"] = wall


# ------------------------------------------------------------ four cards
def four_cards(d: Path, seed: int):
    from dindel_tpu import cli as _cli
    from dindel_tpu.pipeline.run_parallel import run_shards

    fa, bam, _ = simulate_deployment(d, N_WINDOWS + 16, seed)
    cli("--analysis", "getCIGARindels", "--bamFile", bam, "--ref", fa,
        "--outputFile", d / "cand")
    cli("--analysis", "makeWindows", "--inputVarFile",
        d / "cand.variants.txt", "--windowFilePrefix", d / "all")
    n = sum(1 for _ in open(d / "all.1.txt"))
    # one file per card (makeWindows writes numWindowsPerFile + 1 a file)
    cli("--analysis", "makeWindows", "--inputVarFile",
        d / "cand.variants.txt", "--windowFilePrefix", d / "win",
        "--numWindowsPerFile", -(-n // 4) - 1)
    wins = sorted(d.glob("win.*.txt"), key=lambda p: int(p.name.split(".")[1]))
    if n < N_WINDOWS or len(wins) != 4:
        raise RuntimeError(f"{n} windows in {len(wins)} files")
    # the CLI's parameters, so all three runs see the same settings
    params = _cli.params_from_args(_cli.build_parser().parse_args(
        ["--analysis", "indels", "--doDiploid"]))
    t0 = time.perf_counter()
    glfs, stats = run_shards([str(w) for w in wins], [bam], fa, params,
                             str(d / "shards"), backend="fused",
                             num_workers=4)
    log(f"run_shards: 4 workers, {len(wins)} files, "
        f"{time.perf_counter() - t0:.3f} s, windows_ok "
        f"{sum(s['windows_ok'] for s in stats)}")
    if any(s["stage_seconds"].get("slab_rescues") for s in stats):
        raise RuntimeError("slab rescues in run_shards")
    devs = require_gpu()
    if len(devs) < 4:
        raise RuntimeError(f"need 4 GPUs, JAX found {len(devs)}")
    for i, w in enumerate(wins):
        ref = open(glfs[i], "rb").read()
        for name, extra in (("mesh4x1", ("--mesh", "4x1")), ("single", ())):
            out = str(d / f"{name}_{i}")
            st = _cli.run_indels(_cli.build_parser().parse_args(
                ["--analysis", "indels", "--doDiploid", "--bamFile", bam,
                 "--ref", fa, "--varFile", str(w), "--outputFile", out,
                 "--engine", "batched", "--hmmBackend", "fused", *extra]))
            if st["stage_seconds"].get("slab_rescues"):
                raise RuntimeError(f"slab rescues in {name}")
            if open(out + ".glf.txt", "rb").read() != ref:
                raise RuntimeError(f"GLF of {w.name} differs: {name} vs "
                                   "run_shards")
        log(f"{w.name}: GLF identical across run_shards, --mesh 4x1, "
            f"single card ({len(ref)} bytes)")
    return devs


# ------------------------------------------------------------------ main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--only", action="append", choices=PHASES,
                    help="run only these single-card phases")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--warm-pairs", type=int, default=2,
                    help="warm (XLA, fused) diploid run pairs to time")
    args = ap.parse_args()
    compile_cache.enable()
    log(f"card: {card_line()}")
    rec: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        d = Path(tmp)
        if args.four_cards:
            devs = four_cards(d, args.seed)
        else:
            phases = args.only or PHASES
            if "chip_tests" in phases:
                run_chip_tests()
            devs = require_gpu()
            bench = None
            if "kernel" in phases or "oracle" in phases:
                bench = phase_kernel(rec)
            if "oracle" in phases:
                phase_oracle(rec, bench)
            if "diploid" in phases or "pooled" in phases:
                fa, bam, win = phase_diploid(rec, d, args.seed,
                                             args.warm_pairs)
                if "pooled" in phases:
                    phase_pooled(rec, d, fa, bam, win)
        stats = devs[0].memory_stats() or {}
        rec["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    log("results: " + json.dumps(rec))
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
