"""Multi-process host staging feeding ONE device: a device server in the
process that owns the GPU, plus N staging processes that each run
the full host pipeline (getReads -> hapgen -> NW -> pack -> calling ->
GLF) for a disjoint subset of window FILES and ship packed slabs to the
server over a unix socket.

Why: one Python process may not be able to stage windows as fast as the
device scores them, and only one process should open the card (a JAX
process reserves most of its memory).  Staging children are forced to
CPU.  The window FILE is the parallel unit because it
is the reference's own process boundary (python/makeWindows.py:46-54
spawns one dindel job per window file, each with a fresh read buffer),
so per-shard GLF bytes stay identical to sequential runs.

Protocol (length-prefixed pickle over a unix stream socket):
  ("dispatch", id, kind, payload) -> no reply; server runs the slab
      program asynchronously (kind: "stats" | "compact" | "dense")
  ("fetch", [ids])               -> one reply: [fetched pytrees]
  ("bye",)                       -> closes the connection
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
from typing import Any, Dict, List, Optional

_HDR = struct.Struct("<Q")


def _send_msg(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket) -> Any:
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return pickle.loads(_recv_exact(sock, n))


class RemoteHandle:
    """Placeholder for a device result living in the server process."""

    __slots__ = ("rid",)

    def __init__(self, rid: int):
        self.rid = rid

    def __repr__(self):
        return f"RemoteHandle({self.rid})"


# ---------------------------------------------------------------------------
# Server (runs in the process that owns the device)


class DeviceServer:
    """Accepts staging connections and runs slab programs on the local
    jax device.  Dispatches are async (the device queues them);
    fetches block in the requesting connection's thread with the GIL
    released, so other clients keep dispatching."""

    def __init__(self, path: str):
        self.path = path
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(path)
        self._srv.listen(16)
        self._stop = False
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _run(self, kind: str, payload: dict):
        from ..hmm.batch import (run_packed, run_packed_compact,
                                 run_slab_stats_fused)
        if kind == "stats":
            return run_slab_stats_fused(
                payload["merged"], payload["dp_impl"], payload["vtab"],
                payload["callmeta"], payload["max_mismatch"],
                do_call=payload["do_call"])
        if kind == "compact":
            return run_packed_compact(payload["merged"], payload["dp_impl"])
        if kind == "dense":
            return run_packed(payload["merged"], payload["dp_impl"])
        raise ValueError(f"unknown dispatch kind {kind}")

    def _serve(self, conn: socket.socket):
        import time

        import jax
        trace = os.environ.get("DINDEL_DEVSERVER_TRACE") == "1"
        results: Dict[int, Any] = {}
        try:
            while True:
                msg = _recv_msg(conn)
                op = msg[0]
                if op == "dispatch":
                    _, rid, kind, payload = msg
                    t0 = time.perf_counter()
                    try:
                        results[rid] = self._run(kind, payload)
                    except Exception as e:  # ship the fault to the client
                        results[rid] = ("__error__", repr(e))
                    if trace:
                        print(f"[devsrv] dispatch {rid} {kind} "
                              f"{time.perf_counter() - t0:.3f}s", flush=True)
                elif op == "fetch":
                    _, rids = msg
                    # ONE combined device_get for every requested slab:
                    # per-slab fetches each pay a full round trip
                    t0 = time.perf_counter()
                    pending = [results.pop(rid) for rid in rids]
                    ok_idx = [i for i, r in enumerate(pending)
                              if not (isinstance(r, tuple) and len(r) == 2
                                      and r[0] == "__error__")]
                    fetched = jax.device_get([pending[i] for i in ok_idx])
                    t1 = time.perf_counter()
                    out = list(pending)
                    for i, f in zip(ok_idx, fetched):
                        out[i] = f
                    _send_msg(conn, out)
                    if trace:
                        print(f"[devsrv] fetch {rids} get="
                              f"{t1 - t0:.3f}s send="
                              f"{time.perf_counter() - t1:.3f}s", flush=True)
                elif op == "bye":
                    return
        except (ConnectionError, EOFError):
            return
        finally:
            conn.close()

    def close(self):
        self._stop = True
        try:
            self._srv.close()
        except OSError:
            pass
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


# ---------------------------------------------------------------------------
# Client


class DeviceProxy:
    """Staging-process view of the device server.  dispatch() returns a
    RemoteHandle immediately; fetch_pytrees() replaces every RemoteHandle
    in the given pytrees with the server-fetched arrays in ONE round
    trip."""

    def __init__(self, path: str):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.connect(path)
        self._next = 0
        self._lock = threading.Lock()

    def dispatch(self, kind: str, payload: dict) -> RemoteHandle:
        with self._lock:
            rid = self._next
            self._next += 1
            _send_msg(self._sock, ("dispatch", rid, kind, payload))
        return RemoteHandle(rid)

    def _fetch_ids(self, rids: List[int]) -> List[Any]:
        with self._lock:
            _send_msg(self._sock, ("fetch", rids))
            return _recv_msg(self._sock)

    def fetch_pytrees(self, objs: List[Any]) -> List[Any]:
        handles: List[RemoteHandle] = []

        def collect(o):
            if isinstance(o, RemoteHandle):
                handles.append(o)
            elif isinstance(o, dict):
                for v in o.values():
                    collect(v)
            elif isinstance(o, (list, tuple)):
                for v in o:
                    collect(v)

        for o in objs:
            collect(o)
        fetched = self._fetch_ids([h.rid for h in handles])
        table = {h.rid: f for h, f in zip(handles, fetched)}
        for rid, f in table.items():
            if isinstance(f, tuple) and len(f) == 2 and f[0] == "__error__":
                raise RuntimeError(f"remote slab program failed: {f[1]}")

        def subst(o):
            if isinstance(o, RemoteHandle):
                return table[o.rid]
            if isinstance(o, dict):
                return {k: subst(v) for k, v in o.items()}
            if isinstance(o, list):
                return [subst(v) for v in o]
            if isinstance(o, tuple):
                return tuple(subst(v) for v in o)
            return o

        return [subst(o) for o in objs]

    def close(self):
        try:
            _send_msg(self._sock, ("bye",))
        except OSError:
            pass
        self._sock.close()


# ---------------------------------------------------------------------------
# Orchestration: N staging processes + per-shard GLF files


def _staging_main(sock_path: str, bam_paths: List[str], fasta_path: str,
                  params_bytes: bytes, win_files: List[str],
                  glf_paths: List[str], engine_kw: dict,
                  err_path: str, enable_x64: bool,
                  repeats: int = 1, lib_file: Optional[str] = None) -> None:
    """Entry point of one staging process (forced onto CPU so it never
    touches the device; all device work goes via the proxy).  x64 is
    inherited from the parent so the host-vs-device fold routing — and
    with it the GLF bytes — matches a single-process run."""
    try:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", enable_x64)
        import pickle as _p
        from ..engine.batched import BatchedWindowEngine
        params = _p.loads(params_bytes)
        libraries = None
        if lib_file:
            from ..model import LibraryCollection
            libraries = LibraryCollection()
            libraries.add_from_file(lib_file)
        proxy = DeviceProxy(sock_path)
        eng = BatchedWindowEngine([p for p in bam_paths], fasta_path, params,
                                  libraries, remote=proxy, **engine_kw)
        # per-process timing that EXCLUDES interpreter/jax startup, for
        # honest multi-process windows/s numbers (tools/bench_windows)
        import json
        import time
        t0 = time.time()
        marks = []
        for _ in range(repeats):
            r0 = time.time()
            w0 = eng.stats.windows_ok
            for wf, gp in zip(win_files, glf_paths):
                eng.detect_indels(wf, gp)
            marks.append(dict(t0=r0, t1=time.time(),
                              windows=eng.stats.windows_ok - w0))
        t1 = time.time()
        with open(err_path + ".stats", "w") as f:
            json.dump(dict(t_start=t0, t_end=t1, repeats=marks,
                           windows_ok=eng.stats.windows_ok,
                           windows_total=eng.stats.windows_total,
                           stage_seconds=dict(eng.stats.stage_seconds)),
                      f)
        eng.close()
        proxy.close()
    except Exception:
        import traceback
        with open(err_path, "w") as f:
            traceback.print_exc(file=f)
        raise


def run_hostshard(bam_paths: List[str], fasta_path: str, params,
                  win_files: List[str], out_glf: str, n_procs: int = 4,
                  engine_kw: Optional[dict] = None,
                  sock_path: Optional[str] = None,
                  repeats: int = 1, stats_out: Optional[dict] = None,
                  lib_file: Optional[str] = None) -> List[str]:
    """Run the window files through n_procs staging processes feeding
    this process's device, then concatenate the per-shard GLF files into
    out_glf (single header, shard rows in window-file order — byte-equal
    to a sequential multi-file run).  Returns the shard GLF paths."""
    import multiprocessing as mp
    import pickle as _p
    import tempfile

    import jax

    engine_kw = dict(engine_kw or {})
    enable_x64 = bool(jax.config.jax_enable_x64)
    if sock_path is None:
        sock_path = tempfile.mktemp(prefix="dindel_dev_", suffix=".sock")
    server = DeviceServer(sock_path)
    n_procs = max(1, min(n_procs, len(win_files)))
    shards: List[List[str]] = [[] for _ in range(n_procs)]
    for i, wf in enumerate(win_files):
        shards[i % n_procs].append(wf)
    glf_of = {wf: f"{out_glf}.shard{i:03d}"
              for i, wf in enumerate(win_files)}

    ctx = mp.get_context("spawn")
    procs = []
    err_paths = []
    try:
        for s, files in enumerate(shards):
            err = f"{out_glf}.err{s}"
            err_paths.append(err)
            p = ctx.Process(
                target=_staging_main,
                args=(sock_path, bam_paths, fasta_path,
                      _p.dumps(params), files, [glf_of[f] for f in files],
                      engine_kw, err, enable_x64, repeats, lib_file))
            p.start()
            procs.append(p)
        for p in procs:
            p.join()
        for p, err in zip(procs, err_paths):
            if p.exitcode != 0:
                detail = open(err).read() if os.path.exists(err) else ""
                raise RuntimeError(
                    f"staging process failed (exit {p.exitcode}):\n{detail}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        server.close()

    if stats_out is not None:
        import json
        stats = []
        for err in err_paths:
            sp = err + ".stats"
            if os.path.exists(sp):
                stats.append(json.load(open(sp)))
        if stats:
            stats_out["t_start"] = min(st["t_start"] for st in stats)
            stats_out["t_end"] = max(st["t_end"] for st in stats)
            stats_out["windows_ok"] = sum(st["windows_ok"] for st in stats)
            # warm = the BEST repeat past the first across all procs
            # (cold compiles/tracing land in repeat 1; run-to-run
            # spread makes any single repeat a poor estimate)
            nrep = min(len(st.get("repeats", [])) for st in stats)
            best = None
            for k in range(1, nrep):
                marks = [st["repeats"][k] for st in stats]
                span = max(m["t1"] for m in marks) - min(m["t0"] for m in marks)
                wins = sum(m["windows"] for m in marks)
                if span > 0 and (best is None or wins / span > best[0]):
                    best = (wins / span, span, wins)
            if best:
                stats_out["warm_span_s"] = best[1]
                stats_out["warm_windows"] = best[2]
            stats_out["per_proc"] = stats

    # ordered merge: header from the first shard, then every shard's
    # data rows in window-file order
    shard_paths = [glf_of[wf] for wf in win_files]
    with open(out_glf, "w") as out:
        for i, sp in enumerate(shard_paths):
            with open(sp) as f:
                for j, line in enumerate(f):
                    if j == 0 and i > 0:
                        continue  # drop repeated header
                    out.write(line)
    return shard_paths
