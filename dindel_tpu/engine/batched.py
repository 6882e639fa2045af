"""Batched window processing: many realignment windows per device
dispatch.

The per-window engine (window.py) issues one device call per window,
which is latency-bound.  This driver splits work into three phases:

  1. host: read fetch + haplotype generation + NW alignment for a batch
     of windows (per-window fault isolation preserved — failed windows
     become error_* rows exactly as in the streaming engine);
  2. device: ONE pair-HMM dispatch over the concatenated (hap, read)
     pairs of all windows in the batch (slabbed to bound backpointer
     memory);
  3. host: per-window event extraction + Bayesian calling + GLF output.

This is the single-chip arm of the data-parallel design (SURVEY.md
§2.4); parallel/mesh.py shards the same packed batches over dp x rp
meshes."""

from __future__ import annotations

import copy
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Parameters
from ..model import Haplotype, MLAlignment, Read
from ..out.glf import OutputData, make_glf_output
from ..variants import AlignedCandidates, read_window_file
from ..hmm.batch import (BatchedPairHMM, LiksStats, decode_liks_view,
                         merge_compact, pack_pairs, pack_pairs_compact,
                         pad_compact, run_packed, run_packed_compact,
                         run_packed_compact_sharded,
                         run_packed_compact_stats, _round_up)
from ..infer.filterhaps import filter_haplotypes
from ..infer.diploid import diploid_glf, _WindowThrow
from ..infer.device_call import (build_call_tables, diploid_glf_dev,
                                 filter_haplotypes_dev, host_window_folds,
                                 pair_enum, _window_call)
from ..infer.pooled import estimate_hap_freqs_bayes_em
from .reads import ReadBuffer, WindowError, get_reads
from .window import WindowEngine


# Force the device VB-EM path even under x64 (CI executes the production
# pooled device path on CPU this way; see tests/test_device_em.py).
FORCE_DEVICE_EM = False


# Shrink the fetch payload: the (B, L_pad) map_state tensor — ~90% of a
# slab's result bytes — becomes a uint8 hap-position plane plus a
# bit-packed ins-flag plane (0.53x the bytes).  Valid
# whenever S_half = H_pad + 2 <= 255 (gated at the call site); _merge_ms
# reconstructs the exact int16 states on host.
def _split_ms_make(S_half: int):
    @jax.jit
    def f(ms):
        xs8 = (ms % S_half).astype(jnp.uint8)
        ins = jnp.packbits((ms >= S_half).astype(jnp.uint8), axis=1)
        return xs8, ins
    return f


_SPLIT_MS_CACHE = {}


def _split_ms_for(S_half: int):
    f = _SPLIT_MS_CACHE.get(S_half)
    if f is None:
        f = _split_ms_make(S_half)
        _SPLIT_MS_CACHE[S_half] = f
    return f


def _merge_ms(xs8, ins_packed, S_half: int, L_pad: int):
    ms = xs8.astype(np.int16)
    ins = np.unpackbits(ins_packed, axis=1, count=L_pad).astype(bool)
    ms[ins] += S_half
    return ms


class BatchedWindowEngine(WindowEngine):
    """WindowEngine variant that batches the device phase across windows.

    batch_windows controls how many windows are staged per device
    dispatch; max_pairs_per_slab bounds backpointer HBM memory."""

    def __init__(self, *args, batch_windows: int = 128,
                 max_pairs_per_slab: int = 24576, dp_impl: str = "xla",
                 dtype=np.float32, mesh=None, device_call: bool = True,
                 remote=None, **kwargs):
        # Per-window fallback backend when a whole slab faults on device:
        # the batched XLA kernel (ms/window), NOT the float64 oracle
        # (minutes/window at scale).  Bit-parity with the slab path is
        # already guaranteed by the kernel equivalence tests.
        kwargs.setdefault("hmm_backend", "jax")
        super().__init__(*args, **kwargs)
        self.batch_windows = batch_windows
        self.max_pairs_per_slab = max_pairs_per_slab
        self.dp_impl = dp_impl
        self.np_dtype = dtype
        # Device-side calling (SURVEY §3.1 hot loops #3-#4): per-pair
        # stats + filter coverage + diploid pair/site folds run on
        # device and only small per-window arrays are fetched; the
        # (B, L_pad) map_state planes stay on device.  Windows that need
        # per-pair MLAlignments (realigned BAM, --opl) take the
        # full-decode path instead.
        self.device_call = device_call
        # dp x rp device mesh for the slab phase (SURVEY.md §2.4): pairs
        # shard over every mesh device; None = single device.  Accepts a
        # jax.sharding.Mesh or an (n_dp, n_rp) tuple.
        if mesh is not None and not hasattr(mesh, "devices"):
            from ..parallel.mesh import make_mesh
            mesh = make_mesh(*mesh)
        self.mesh = mesh
        # Multi-process host staging (parallel/hostshard.py): when set,
        # every slab program runs in the device-server process and this
        # engine only ships packed numpy tables / fetches result arrays.
        self.remote = remote
        if remote is not None and mesh is not None:
            raise ValueError("remote staging and mesh sharding are exclusive")
        # global FIFO of dispatched-not-yet-fetched slabs, shared across
        # batches: each item is (out_dict, (slab, pks, compact, res))
        self._inflight: List[tuple] = []
        # set by the finish worker the moment the previous batch's
        # combined fetch has landed; the next batch's dispatches wait on
        # it so result downloads never interleave with slab uploads
        self._prev_fetch_done: Optional[threading.Event] = None

    # ------------------------------------------------------------------
    def detect_indels(self, var_file: str, glf_path: Optional[str] = None):
        p = self.params
        if glf_path is None:
            glf_path = p.file_name + ".glf.txt"
        out = open(glf_path, "w")
        glf_data = make_glf_output(out)
        glf_data.write_header()

        self.buf = ReadBuffer()
        self.buf.reset = True
        old_tid = "-1"
        all_rows: List[dict] = []
        # No cross-call overlap exists; a stale unset Event from an
        # aborted previous call would deadlock the first _flush_begin.
        self._prev_fetch_done = None

        staged: List[dict] = []
        # Single finish worker: batch N's fetch + decode + calling + GLF
        # write run on this thread while the main thread stages batch N+1
        # (the combined device_get waits on the device with the GIL
        # released, and the staging loop's BAM/NW/hapgen work runs in
        # GIL-releasing native code).  One worker + FIFO futures keep GLF
        # rows in window order; the worker never touches self.params (it
        # gets a per-batch copy) or self._inflight.
        finisher = ThreadPoolExecutor(max_workers=1)
        pending_fut = None  # previous batch's in-progress finish
        index = 0
        try:
          for candidates in read_window_file(var_file, p.var_file_is_one_based):
            index += 1
            left_pos = candidates.left_pos
            right_pos = candidates.right_pos
            pos = candidates.center_pos
            p.tid = candidates.tid
            if p.tid != old_tid:
                self.buf.reset = True
                old_tid = p.tid
                self.buf.old_left_pos = 0
            if left_pos < self.buf.old_left_pos:
                raise RuntimeError(
                    "Candidate variant files must be sorted on left position of window!")
            self.stats.windows_total += 1
            entry = dict(index=index, tid=p.tid, pos=pos,
                         left_pos=left_pos, right_pos=right_pos,
                         candidates=candidates, error=None)
            try:
                with self.stats.stage("get_reads"):
                    reads = get_reads(self.bams, p.tid, left_pos, right_pos,
                                      p, self.libraries, self.buf)
                self.buf.reset = False
                with self.stats.stage("hapgen"):
                    skip, haps, lp2, rp2 = self.get_haplotypes(
                        reads, pos, left_pos, right_pos, candidates)
                if len(reads) * len(haps) > p.max_hap_read_prod:
                    raise WindowError(
                        f"skipped_numhap_times_numread>{p.max_hap_read_prod}")
                entry.update(reads=reads, haps=haps, skip=skip,
                             left_pos=lp2, right_pos=rp2)
            except WindowError as e:
                entry["error"] = "error_" + str(e).replace(" ", "_")
                self.stats.record_error(entry["error"])
                self.buf.reset = True
            except MemoryError:
                entry["error"] = "error_bad_alloc"
                self.stats.record_error(entry["error"])
                self.buf.reset = True
            self.buf.old_left_pos = entry["left_pos"] if entry["error"] is None else left_pos
            staged.append(entry)
            if len(staged) >= self.batch_windows:
                # Dispatch this batch's slabs to the device, hand the
                # finish phase (fetch + call + write) to the worker, then
                # keep staging: the device crunches batch N and the
                # worker drains it while the host stages batch N+1.
                # Collecting the previous future first bounds the
                # pipeline to one batch in each phase.
                new_pending = self._flush_begin(staged)
                if pending_fut is not None:
                    all_rows.extend(pending_fut.result())
                pending_fut = finisher.submit(self._flush_end, new_pending,
                                              glf_data)
                staged = []
          if staged:
              new_pending = self._flush_begin(staged)
              if pending_fut is not None:
                  all_rows.extend(pending_fut.result())
                  pending_fut = None
              pending_fut = finisher.submit(self._flush_end, new_pending,
                                            glf_data)
          if pending_fut is not None:
              all_rows.extend(pending_fut.result())
        finally:
            finisher.shutdown(wait=True)
            out.close()
        return all_rows

    # ------------------------------------------------------------------
    def _flush(self, staged: List[dict], glf_data: OutputData) -> List[dict]:
        return self._flush_end(self._flush_begin(staged), glf_data)

    def _flush_begin(self, staged: List[dict]) -> dict:
        """Partition the batch's good windows into slabs and dispatch
        them (async).  Older in-flight slabs — possibly the previous
        batch's — are finished as needed to hold the global in-flight
        depth, so device backpointer memory stays bounded while batches
        overlap."""
        good = [e for e in staged
                if e["error"] is None and not e.get("skip") and e.get("haps")]
        # Transfer discipline: don't start uploading this batch's slabs
        # until the previous batch's result download has finished (its
        # fetch then only ever overlaps pure-host staging work).
        if self._prev_fetch_done is not None:
            with self.stats.stage("fetch_gate"):
                self._prev_fetch_done.wait()
        fetch_done = threading.Event()
        self._prev_fetch_done = fetch_done
        out: dict = {}
        slab: List[dict] = []
        slab_pairs = 0
        with self.stats.stage("device_hmm"):
            for e in good:
                n = len(e["haps"]) * len(e["reads"])
                if slab and slab_pairs + n > self.max_pairs_per_slab:
                    self._push_slab(out, slab)
                    slab = []
                    slab_pairs = 0
                slab.append(e)
                slab_pairs += n
            if slab:
                self._push_slab(out, slab)
        # Hand this batch's dispatched-not-yet-fetched slabs to the
        # finish phase: from here on only the finish worker owns them,
        # so _inflight stays a main-thread-only structure.
        mine = [item for item in self._inflight if item[0] is out]
        self._inflight = [it for it in self._inflight if it[0] is not out]
        # The finish worker must not mutate shared engine state while the
        # main thread stages the next batch; give it its own Parameters
        # view (tid is set per window during calling).
        return dict(staged=staged, out=out, items=mine,
                    params=copy.copy(self.params), fetch_done=fetch_done)

    def _flush_end(self, pending: dict, glf_data: OutputData) -> List[dict]:
        staged = pending["staged"]
        liks_by_idx = pending["out"]
        try:
            with self.stats.stage("device_hmm"):
                self._drain_for(liks_by_idx, pending["items"],
                                pending["params"])
        finally:
            pending["fetch_done"].set()
        p = pending["params"]  # per-batch copy; KeyError > silent race
        # Pooled device EM (VB-EM iteration DInDel.cpp:2431-2523 on
        # device, infer/device_em): batch every pooled window's active
        # sets into ONE dispatch; f32 production path only — under x64
        # the host numpy loop stays the byte-parity anchor.
        dev_em = (p.estimate_hap_freqs and self.device_call
                  and self.remote is None
                  and (FORCE_DEVICE_EM or not jax.config.jax_enable_x64))
        if dev_em:
            from ..infer.device_em import run_batched_em
            from ..infer.pooled import em_inputs
            insts, keys = [], []
            for e in staged:
                if e["error"] is not None or e.get("skip"):
                    continue
                liks = liks_by_idx.get(e["index"])
                if not (isinstance(liks, tuple) and liks[0] == "dev"):
                    continue  # rescued slab -> host EM
                _tag, view, _dev = liks
                filtered, var_cov = filter_haplotypes_dev(
                    e["haps"], e["reads"], view, e["ctab"], p,
                    p.filter_haplotypes)
                e["_fv"] = (filtered, var_cov)
                rlT, compat, numah = em_inputs(
                    e["haps"], e["reads"], view, p, filtered, p.bayes_type)
                if compat.shape[0]:
                    insts.append((rlT, compat, numah))
                    keys.append(e)
            if insts:
                with self.stats.stage("device_em"):
                    res = run_batched_em(insts, p.bayes_a0, p.em_tol,
                                         dtype=self.np_dtype)
                for e, r in zip(keys, res):
                    e["_em_res"] = r
        rows: List[dict] = []
        for e in staged:
            if e["error"] is not None:
                line = glf_data.line()
                line.set("msg", e["error"])
                line.set("index", e["index"])
                line.set("tid", e["tid"])
                line.set("lpos", e["left_pos"])
                line.set("rpos", e["right_pos"])
                glf_data.output(line)
                continue
            if e.get("skip"):
                continue
            p.tid = e["tid"]
            try:
                liks = liks_by_idx.get(e["index"])
                if liks is None:
                    continue
                rows.extend(self._call_window(e, liks, glf_data, p))
                self.stats.record_ok(len(e["reads"]))
            except WindowError as err:
                msg = "error_" + str(err).replace(" ", "_")
                self.stats.record_error(msg)
                line = glf_data.line()
                line.set("msg", msg)
                line.set("index", e["index"])
                line.set("tid", e["tid"])
                line.set("lpos", e["left_pos"])
                line.set("rpos", e["right_pos"])
                glf_data.output(line)
        return rows

    # ------------------------------------------------------------------
    # In-flight slab pipeline depth.  Fused ("stats") slabs are a single
    # dispatch whose multi-GB backpointer tensors never surface as
    # dispatch outputs, so any number can queue (bounded loosely at
    # MAX_INFLIGHT).  Non-fused slabs materialize bt tensors between
    # their dp and finish dispatches — PjRt allocates those outputs at
    # ENQUEUE time — so at most PIPELINE_DEPTH of them may be in flight.
    PIPELINE_DEPTH = 4
    MAX_INFLIGHT = 256

    def _want_device_call(self) -> bool:
        p = self.params
        return (self.device_call
                and not p.output_realigned_bam
                and not p.output_pooled_likelihoods)

    def _stage_slab(self, slab):
            """Host pack + async device dispatch; returns in-flight
            state.  Uses the compact per-read/per-hap table format
            (~20x smaller device upload; see pack_pairs_compact) unless a
            window needs the insert-size positional prior, in which case
            the whole slab ships dense.

            In device-call mode (the default) the dispatch also runs the
            per-pair stats pass and the per-window diploid read folds on
            device; only per-pair scalars + per-window matrices come
            back."""
            p = self.params
            H_max = max(max(h.size() for h in e["haps"]) for e in slab)
            L_max = max(max(r.size() for r in e["reads"]) for e in slab)
            # one shape bucket for both DP implementations
            H_pad = _round_up(H_max, 16)
            L_pad = _round_up(max(L_max, 2), 16)
            with self.stats.stage("slab_pack"):
                pks = []
                for e in slab:
                    pks.append(pack_pairs_compact(
                        e["haps"], e["reads"], e["left_pos"], p.obs_params,
                        self.np_dtype, H_pad=H_pad, L_pad=L_pad))
                compact = not any(pk is None for pk in pks)
                if not compact:
                    pks = [pack_pairs(e["haps"], e["reads"], e["left_pos"],
                                      p.obs_params, self.np_dtype,
                                      H_pad=H_pad, L_pad=L_pad)
                           for e in slab]
                use_dev = compact and self._want_device_call()
                if use_dev:
                    for e in slab:
                        e["ctab"] = build_call_tables(
                            e["haps"], e["candidates"], e["left_pos"], p)
                    # A flank window reaching the LO/RO sentinel codes
                    # (left_flank_read - padCover <= -3, possible via the
                    # load-bearing negative-flank quirks) makes the
                    # device slot-coverage fold diverge from the host
                    # column-wise this_covered computation — route the
                    # slab through the full-decode host path instead.
                    if any((e["ctab"]["v_valid"]
                            & (e["ctab"]["v_left"] <= -3)).any()
                           for e in slab):
                        use_dev = False
            with self.stats.stage("slab_dispatch"):
                if use_dev:
                    mode = "stats"
                    res = self._dispatch_stats(slab, pks)
                elif compact:
                    mode = "compact"
                    merged = pad_compact(merge_compact(pks))
                    if self.remote is not None:
                        res = self.remote.dispatch(
                            "compact",
                            dict(merged=merged, dp_impl=self.dp_impl))
                    elif self.mesh is not None:
                        res = run_packed_compact_sharded(
                            merged, self.dp_impl, self.mesh)
                    else:
                        res = run_packed_compact(merged, self.dp_impl)
                else:
                    mode = "dense"
                    keys = ["hap_len", "read_len", "b_mid", "read_codes",
                            "hap_codes", "eq", "uq", "lpe", "lpn", "lpeV",
                            "lpnV", "prior_rmq", "prior_hmq"]
                    merged = {k: np.concatenate([pk[k] for pk in pks])
                              for k in keys}
                    merged.update(H_pad=H_pad, L_pad=L_pad,
                                  numT=pks[0]["numT"],
                                  scalars=pks[0]["scalars"], nh=0, nr=0)
                    if self.remote is not None:
                        res = self.remote.dispatch(
                            "dense",
                            dict(merged=merged, dp_impl=self.dp_impl))
                    else:
                        res = run_packed(merged, self.dp_impl)  # async
                if (self.remote is None
                        and mode in ("compact", "dense") and H_pad + 2 <= 255):
                    # 7-tuple wire format: map_state split into uint8
                    # hap-position + packed ins bits (0.53x fetch bytes)
                    xs8, insb = _split_ms_for(H_pad + 2)(res[-1])
                    res = res[:-1] + (xs8, insb)
            return slab, pks, mode, res

    def _dispatch_stats(self, slab, pks):
        """Device-call dispatch: DP + finish + pair stats + window folds,
        all async on device; returns {'stats': ..., 'base': ..., 'site':
        ...} device pytree."""
        p = self.params
        merged = pad_compact(merge_compact(pks))
        # per-hap variant flank tables, aligned row-for-row with the
        # merged (and padded) compact hap tables
        vmax = max((len(e["ctab"]["slot_vars"][h])
                    for e in slab for h in range(len(e["haps"]))),
                   default=0)
        V = max(2, 1 << (max(vmax, 1) - 1).bit_length())
        n_hap_rows = merged["hap_codes_h"].shape[0]
        v_left = np.zeros((n_hap_rows, V), np.int32)
        v_right = np.zeros((n_hap_rows, V), np.int32)
        v_isdel = np.zeros((n_hap_rows, V), bool)
        v_valid = np.zeros((n_hap_rows, V), bool)
        row = 0
        for e in slab:
            ct = e["ctab"]
            nh = len(e["haps"])
            v_left[row:row + nh, :ct["v_left"].shape[1]] = ct["v_left"]
            v_right[row:row + nh, :ct["v_right"].shape[1]] = ct["v_right"]
            v_isdel[row:row + nh, :ct["v_isdel"].shape[1]] = ct["v_isdel"]
            v_valid[row:row + nh, :ct["v_valid"].shape[1]] = ct["v_valid"]
            row += nh
        vtab = dict(v_left_h=v_left, v_right_h=v_right,
                    v_isdel_h=v_isdel, v_valid_h=v_valid)

        # per-window diploid read folds: scatter the slab's flat ll into
        # a (W, NH, NR) tensor and fold in the reference's order.
        # Statics quantize COARSELY (pow2 W/NR/S, NH pinned to maxHap):
        # every distinct combination is a fresh XLA compile of the fused
        # program (tens of seconds cold), so bound the combination count
        # hard.
        W = max(8, 1 << (len(slab) - 1).bit_length())
        NH = max(p.max_hap, max(len(e["haps"]) for e in slab))
        NR = max(len(e["reads"]) for e in slab)
        NR = max(64, 1 << (NR - 1).bit_length())
        S = max(len(e["ctab"]["var_positions"]) for e in slab)
        S = max(4, 1 << (max(S, 1) - 1).bit_length())
        h1p, h2p = pair_enum(NH)
        NP = len(h1p)
        kmap_of = {}
        B = merged["hap_idx"].shape[0]
        # gather map (W, NH, NR) slot -> flat pair index (0 for pads;
        # garbage masked downstream).  A gather, not a scatter: the
        # gather map is built on host, and the device only reads.
        index_map = np.zeros((W, NH, NR), np.int32)
        nr_w = np.zeros(W, np.int32)
        calldt = (np.float64 if jax.config.jax_enable_x64 else np.float32)
        pair_pr = np.zeros((W, S, NP), calldt)
        off = 0
        for w, e in enumerate(slab):
            ct = e["ctab"]
            nh = len(e["haps"])
            nr = len(e["reads"])
            idx = off + (np.arange(nh, dtype=np.int32)[:, None] * nr
                         + np.arange(nr, dtype=np.int32)[None, :])
            index_map[w, :nh, :nr] = idx
            nr_w[w] = nr
            # window pair k -> padded pair index under the NH enumeration
            kmap = (ct["h1v"] * (2 * NH - ct["h1v"] + 1)) // 2 \
                + (ct["h2v"] - ct["h1v"])
            kmap_of[e["index"]] = kmap
            ns = len(ct["var_positions"])
            if ns:
                pair_pr[w, :ns, kmap] = ct["pair_pr"].T
            off += nh * nr
        # With x64 enabled (every parity/CPU configuration) the fold
        # math runs on host so GLF bytes stay anchored to numpy/libm
        # exp-rounding; the device fold serves f32 production
        do_call = not jax.config.jax_enable_x64
        if self.remote is not None:
            callmeta = dict(W=W, NH=NH, S=S, NR=NR, index_map=index_map,
                            nr_w=nr_w, pair_pr=pair_pr)
            h = self.remote.dispatch(
                "stats", dict(merged=merged, dp_impl=self.dp_impl,
                              vtab=vtab, callmeta=callmeta,
                              max_mismatch=p.obs_params.max_mismatch,
                              do_call=do_call))
            return dict(packed=h, kmap_of=kmap_of, V=V, do_call=do_call)
        if self.mesh is None:
            # fused single-device program: 3 dispatches, 6 fetch leaves
            from ..hmm.batch import run_slab_stats_fused
            callmeta = dict(W=W, NH=NH, S=S, NR=NR, index_map=index_map,
                            nr_w=nr_w, pair_pr=pair_pr)
            packed = run_slab_stats_fused(
                merged, self.dp_impl, vtab, callmeta,
                p.obs_params.max_mismatch, do_call=do_call)
            return dict(packed=packed, kmap_of=kmap_of, V=V,
                        do_call=do_call)
        res = run_packed_compact_stats(
            merged, self.dp_impl, vtab, p.obs_params.max_mismatch,
            mesh=self.mesh)
        if do_call:
            base, site = _window_call(
                W, NH, S, NR, res["ll"], jnp.asarray(index_map),
                jnp.asarray(nr_w), jnp.asarray(pair_pr))
        else:
            base = site = np.zeros(0)
        return dict(stats=res, base=base, site=site, kmap_of=kmap_of,
                    do_call=do_call)

    def _finish_slab(self, out, staged, fetched=None, params=None):
            """Blocking fetch (unless prefetched) + vectorized decode.

            On the finish worker `params` is the per-batch copy; only
            the main thread may fall back to self.params."""
            p = self.params if params is None else params
            slab, pks, mode, res = staged
            if fetched is None:
                with self.stats.stage("slab_fetch"):
                    # one pytree fetch (pipelined transfers) instead of
                    # six sequential round trips
                    if self.remote is not None:
                        fetched = self.remote.fetch_pytrees([res])[0]
                    else:
                        fetched = jax.device_get(res)
            if mode == "stats":
                self._finish_slab_stats(out, slab, pks, fetched, p)
                return
            compact = (mode == "compact")
            if len(fetched) == 7:
                (ll, off_hap, off_hap_hmq, ll_off, ll_on, xs8, insb) = fetched
                L_pad = pks[0]["L_pad"]
                map_state = _merge_ms(np.asarray(xs8), np.asarray(insb),
                                      pks[0]["H_pad"] + 2, L_pad)
            else:
                (ll, off_hap, off_hap_hmq, ll_off, ll_on, map_state) = fetched
            off = 0
            with self.stats.stage("slab_decode"):
              for e, pk in zip(slab, pks):
                B = pk["hap_len"].shape[0]
                sl = slice(off, off + B)
                if compact:
                    # dense per-pair code view for the decode (host gather)
                    pk = dict(H_pad=pk["H_pad"], L_pad=pk["L_pad"],
                              hap_len=pk["hap_len"],
                              read_len=pk["read_len"],
                              hap_codes=pk["hap_codes_h"][pk["hap_idx"]],
                              read_codes=pk["read_codes_r"][pk["read_idx"]])
                out[e["index"]] = decode_liks_view(
                    e["haps"], e["reads"], pk, ll[sl], off_hap[sl],
                    off_hap_hmq[sl], ll_off[sl], ll_on[sl], map_state[sl],
                    p.obs_params)
                off += B

    def _finish_slab_stats(self, out, slab, pks, fetched, params=None):
        """Device-call finish: slice the per-pair stat vectors and the
        per-window fold matrices; no map_state, no host decode."""
        obs = (self.params if params is None else params).obs_params
        if "packed" in fetched:
            f_plane, m_log_bq, i_plane, b_plane, base, site = [
                np.asarray(a) for a in fetched["packed"]]
            i_plane = i_plane.astype(np.int32)
            b_plane = np.unpackbits(
                b_plane, axis=1, count=4 + fetched["V"]).astype(bool)
            st = dict(ll=f_plane[:, 0], ll_off=f_plane[:, 1],
                      ll_on=f_plane[:, 2], m_log_bq=m_log_bq,
                      fb=i_plane[:, 0], lb=i_plane[:, 1],
                      n_bqt=i_plane[:, 2], n_mm_bqt=i_plane[:, 3],
                      n_mm_left=i_plane[:, 4], n_mm_right=i_plane[:, 5],
                      num_mm=i_plane[:, 6], n_ind=i_plane[:, 7],
                      off_hap=b_plane[:, 0], off_hap_hmq=b_plane[:, 1],
                      has_event=b_plane[:, 2], any_mism=b_plane[:, 3],
                      cov_ok=b_plane[:, 4:])
            base = np.asarray(base, np.float64)
            site = np.asarray(site, np.float64)
            kmap_of = fetched["kmap_of"]
            do_call = fetched["do_call"]
            off = 0
            with self.stats.stage("slab_decode"):
                for w, (e, pk) in enumerate(zip(slab, pks)):
                    B = pk["hap_len"].shape[0]
                    sl = slice(off, off + B)
                    view = LiksStats(e["haps"], e["reads"], obs,
                                     pk["read_len"], pk["hap_len"],
                                     {k: v[sl] for k, v in st.items()})
                    if do_call:
                        kmap = kmap_of[e["index"]]
                        ns = len(e["ctab"]["var_positions"])
                        dev = dict(base=base[w][kmap],
                                   site=site[w][:ns][:, kmap] if ns
                                   else np.zeros((0, len(kmap))))
                    else:
                        hb, hs = host_window_folds(view.ll2d, e["ctab"])
                        dev = dict(base=hb, site=hs)
                    out[e["index"]] = ("dev", view, dev)
                    off += B
            return
        st = {k: np.asarray(v) for k, v in fetched["stats"].items()}
        base = np.asarray(fetched["base"], np.float64)
        site = np.asarray(fetched["site"], np.float64)
        kmap_of = fetched["kmap_of"]
        do_call = fetched["do_call"]
        off = 0
        with self.stats.stage("slab_decode"):
            for w, (e, pk) in enumerate(zip(slab, pks)):
                B = pk["hap_len"].shape[0]
                sl = slice(off, off + B)
                view = LiksStats(e["haps"], e["reads"], obs,
                                 pk["read_len"], pk["hap_len"],
                                 {k: v[sl] for k, v in st.items()})
                if do_call:
                    kmap = kmap_of[e["index"]]
                    ns = len(e["ctab"]["var_positions"])
                    dev = dict(base=base[w][kmap],
                               site=site[w][:ns][:, kmap] if ns
                               else np.zeros((0, len(kmap))))
                else:
                    hb, hs = host_window_folds(view.ll2d, e["ctab"])
                    dev = dict(base=hb, site=hs)
                out[e["index"]] = ("dev", view, dev)
                off += B

    def _rescue_slab(self, out, slab):
        """Slab-level fault isolation: if the packed device phase for
        a slab throws, re-score each window individually through the
        per-window backend (batched XLA kernel by default) so one
        pathological window cannot take down its slab-mates.
        Per-window failures surface as error_* rows via the entry.
        Every rescue is counted in stats.stage_seconds["slab_rescues"]:
        a device program that fails to compile or run on a new device
        would otherwise look like a slow, correct run, so benchmarks and
        chip_smoke.py treat any rescue as a failure.

        Note: on the finish worker this dispatches+fetches device work
        while the main thread may be uploading the next batch's slabs,
        violating the fetch-vs-upload discipline — accepted for this
        rare fault path (correct, just slow when it triggers)."""
        import sys
        import traceback
        with self.stats.lock:
            self.stats.stage_seconds["slab_rescues"] = (
                self.stats.stage_seconds.get("slab_rescues", 0.0) + 1)
        if not getattr(self, "_rescue_reported", False):
            self._rescue_reported = True
            print("WARNING: slab device phase failed; per-window rescue "
                  f"engaged (thread={threading.current_thread().name})."
                  " First cause:", file=sys.stderr)
            traceback.print_exc(file=sys.stderr)
        for e in slab:
            try:
                liks, _on_hap = self.compute_likelihoods(
                    e["haps"], e["reads"], e["left_pos"])
                out[e["index"]] = liks
            except WindowError as err:
                e["error"] = "error_" + str(err).replace(" ", "_")
                self.stats.record_error(e["error"])

    def _push_slab(self, out, slab):
        """Dispatch one slab, first finishing the oldest in-flight slabs
        (FIFO, possibly an earlier batch's) to respect the depth caps."""
        def bt_holders():
            return sum(1 for _it in self._inflight if _it[1][2] != "stats")

        while (len(self._inflight) >= self.MAX_INFLIGHT
               or bt_holders() >= self.PIPELINE_DEPTH):
            self._pop_slab()
        try:
            st = self._stage_slab(slab)
            self._inflight.append((out, st))
        except Exception:
            self._rescue_slab(out, slab)

    def _pop_slab(self):
        out, st = self._inflight.pop(0)
        try:
            self._finish_slab(out, st)
        except Exception:
            self._rescue_slab(out, st[0])

    def _drain_for(self, out, mine, params=None):
        """Finish every slab belonging to `out` (handed over by
        _flush_begin).  All their results come back in ONE device_get —
        one round trip per batch instead of one per slab — then each
        slab decodes from its prefetched arrays."""
        if not mine:
            return
        try:
            with self.stats.stage("slab_fetch"):
                if self.remote is not None:
                    fetched = self.remote.fetch_pytrees(
                        [st[3] for _, st in mine])
                else:
                    fetched = jax.device_get([st[3] for _, st in mine])
        except Exception:
            # combined fetch failed (a slab's device phase threw):
            # retry slab-by-slab so healthy slabs still land and only
            # the faulty one takes the per-window rescue path.
            fetched = [None] * len(mine)
        for (o, st), f in zip(mine, fetched):
            try:
                self._finish_slab(o, st, fetched=f, params=params)
            except Exception:
                self._rescue_slab(o, st[0])

    # ------------------------------------------------------------------
    def _call_window(self, e, liks, glf_data, p=None) -> List[dict]:
        p = self.params if p is None else p
        haps = e["haps"]
        reads = e["reads"]
        dev = None
        if isinstance(liks, tuple) and liks[0] == "dev":
            _tag, liks, dev = liks
        from .window import check_guards_and_on_hap
        on_hap_flags = check_guards_and_on_hap(liks, len(haps), len(reads))
        rows: List[dict] = []
        with self.stats.stage("calling"):
            if dev is not None:
                ctab = e["ctab"]
                fv = e.get("_fv")
                filtered, var_coverage = fv if fv else filter_haplotypes_dev(
                    haps, reads, liks, ctab, p, p.filter_haplotypes)
                if p.estimate_hap_freqs:
                    _f, _p, emrows = estimate_hap_freqs_bayes_em(
                        haps, reads, liks, e["pos"], e["left_pos"],
                        e["right_pos"], glf_data, e["index"],
                        e["candidates"], p, filtered, var_coverage,
                        len(self.bams), p.bayes_type,
                        em_results=e.get("_em_res"))
                    rows.extend(emrows)
                if p.do_diploid:
                    try:
                        rows.extend(diploid_glf_dev(
                            haps, reads, liks, dev["base"], dev["site"],
                            e["pos"], e["left_pos"], e["right_pos"],
                            glf_data, e["index"], ctab, p, filtered,
                            var_coverage, "dip"))
                    except _WindowThrow as err:
                        raise WindowError(str(err))
                return rows
            if p.estimate_hap_freqs:
                filtered, var_coverage = filter_haplotypes(
                    haps, reads, liks, p, p.filter_haplotypes)
                _f, _p, emrows = estimate_hap_freqs_bayes_em(
                    haps, reads, liks, e["pos"], e["left_pos"], e["right_pos"],
                    glf_data, e["index"], e["candidates"], p, filtered,
                    var_coverage, len(self.bams), p.bayes_type)
                rows.extend(emrows)
            if p.do_diploid:
                filtered, var_coverage = filter_haplotypes(
                    haps, reads, liks, p, p.filter_haplotypes)
                try:
                    rows.extend(diploid_glf(
                        haps, reads, liks, e["pos"], e["left_pos"],
                        e["right_pos"], glf_data, e["index"], e["candidates"],
                        p, filtered, var_coverage, "dip"))
                except _WindowThrow as err:
                    raise WindowError(str(err))
            if p.output_realigned_bam and p.slower:
                # same per-window realigned-BAM contract (and write
                # order/overwrite quirk when both callers are on) as the
                # streaming engine (DInDel.cpp:498-534, 589-633); on_hap
                # from the decoded HMQ flags (DInDel.cpp:1717-1720)
                on_hap = on_hap_flags
                if p.do_diploid:
                    self._write_realigned_bam(
                        e["index"], haps, reads, liks, on_hap,
                        e["left_pos"], e["right_pos"], e["candidates"],
                        diploid=True, params=p)
                if p.estimate_hap_freqs:
                    self._write_realigned_bam(
                        e["index"], haps, reads, liks, on_hap,
                        e["left_pos"], e["right_pos"], e["candidates"],
                        diploid=False, params=p)
        return rows
