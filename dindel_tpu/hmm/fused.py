"""Fused pair-HMM DP: both recursions of a pair in one kernel launch.

Same contract as hmm/batch._dp_xla (alpha/beta bMid slices, forward and
backward backpointers) and bit-identical to it in float32, with two
differences in what comes back:

- backpointers are one byte per state, the 4-bit transition class of the
  noins state in the low nibble and of the ins state in the high nibble,
  (L_pad-1, B, S_half) uint8 — decode with _finish(bt_codes=True) or, on
  host, expand_bt_codes;
- each pair runs its forward pass only up to its own b_mid and its
  backward pass only down to it, so forward rows >= b_mid and backward
  rows < b_mid are left unwritten: exactly the rows _finish discards.

The kernel is C++ (native/pairhmm/dp_core.h) compiled twice: by nvcc into
a CUDA kernel (one warp per pair, DP rows in shared memory) and by g++
into a host loop that the CPU tests run.  Both are XLA FFI targets under
one name; the platform a program is lowered for picks the build.  The
libraries are built from the tracked sources at first use into
native/build/ (gitignored), or ahead of time with
``python -m dindel_tpu.hmm.fused``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

TARGET = "dindel_pairhmm_dp"

_SRC = Path(__file__).resolve().parents[2] / "native" / "pairhmm"
_BUILD = _SRC.parent / "build"
_lock = threading.Lock()
_registered = set()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("the fused DP kernel needs nvcc (CUDA toolkit)")
    return nvcc


# (compiler, flags, source) per platform; contraction stays off so the
# kernel rounds every sum exactly as written
_TOOLCHAIN = {
    "gpu": ("nvcc", ["-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", "-fmad=false", "-shared",
                     "-Xcompiler", "-fPIC"], "dp_cuda.cu"),
    "cpu": ("g++", ["-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC"], "dp_cpu.cc"),
}


def build(platform: str) -> Path:
    """Build (once per source version) the kernel library for `platform`
    ('cpu' or 'gpu') and return its path.  Safe under concurrent
    processes: the build runs under a file lock and lands atomically."""
    cc, flags, src = _TOOLCHAIN[platform]
    h = hashlib.sha1(" ".join(flags).encode())
    for name in ("dp_core.h", src):
        h.update((_SRC / name).read_bytes())
    so = _BUILD / f"libdindel_pairhmm_{platform}_{h.hexdigest()[:12]}.so"
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    with open(_BUILD / ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not so.exists():
            tmp = so.with_suffix(f".tmp{os.getpid()}")
            exe = _nvcc() if cc == "nvcc" else cc
            r = subprocess.run([exe, *flags, "-I", jax.ffi.include_dir(),
                                "-o", str(tmp), str(_SRC / src)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"building {so.name} failed:\n"
                                   + r.stderr[-4000:])
            os.replace(tmp, so)
    return so


def _register(platform: str) -> None:
    with _lock:
        if platform in _registered:
            return
        lib = ctypes.cdll.LoadLibrary(str(build(platform)))
        sym = ("DindelPairhmmDpCuda" if platform == "gpu"
               else "DindelPairhmmDpCpu")
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(getattr(lib, sym)),
            platform="CUDA" if platform == "gpu" else "cpu")
        _registered.add(platform)


def dp_fused(H_pad, L_pad, numT,
             hap_len, read_len, b_mid, read_codes, hap_codes,
             eq, uq, lpe, lpn, lpeV, lpnV, scalars):
    """The fused DP, with _dp_xla's signature (lpeV/lpnV are rebuilt in
    the kernel from lpe/lpn and the hap length, and ignored here).
    float32 only; numT = maxLengthDel + 2 must fit a 4-bit code."""
    del lpeV, lpnV
    if numT > 15:
        raise ValueError("the fused DP stores 4-bit backpointer classes; "
                         f"numT = maxLengthDel + 2 must be <= 15 (got {numT})"
                         " — use the XLA DP beyond that")
    if jnp.dtype(eq.dtype) != jnp.float32:
        raise TypeError(f"the fused DP is float32-only (got {eq.dtype})")
    platform = jax.devices()[0].platform
    _register(platform)
    B = hap_len.shape[0]
    S = H_pad + 2
    if read_codes.shape != (B, L_pad) or lpe.shape != (B, S):
        raise ValueError("packed shapes disagree with H_pad/L_pad")
    out = (jax.ShapeDtypeStruct((B, 2 * S), jnp.float32),
           jax.ShapeDtypeStruct((B, 2 * S), jnp.float32),
           jax.ShapeDtypeStruct((L_pad - 1, B, S), jnp.uint8),
           jax.ShapeDtypeStruct((L_pad - 1, B, S), jnp.uint8))
    i32 = lambda a: jnp.asarray(a).astype(jnp.int32)
    u8 = lambda a: jnp.asarray(a).astype(jnp.uint8)
    return jax.ffi.ffi_call(TARGET, out, vmap_method="sequential")(
        i32(hap_len), i32(read_len), i32(b_mid), u8(read_codes),
        u8(hap_codes), jnp.asarray(eq), jnp.asarray(uq), jnp.asarray(lpe),
        jnp.asarray(lpn), jnp.asarray(scalars).astype(jnp.float32),
        num_t=np.int32(numT))


def expand_bt_codes(btf, btb, hap_len, H_pad, numT, xp=np):
    """Expansion of the byte backpointer class codes into full
    source-state index planes, (L, B, 2*S_half) int32 — the _dp_xla
    backpointer format.  For differential checks (xp=numpy on host,
    xp=jax.numpy on device); _finish decodes along the MAP path only.

    Forward (Dec) codes, at dest state x:
      noins interior: 0 -> ins x-1, 1 -> self, 1+y -> noins max(x-y, 0)
      noins RO:       0 -> ins RO, 1 -> ins hl, 2 -> noins RO, 3 -> noins hl
      ins:            0 -> ins x (extend), 1 -> noins x (open)
    Backward (Inc) codes:
      noins: 0 -> ins x, numT -> self, c -> noins clamp(x + (numT-c))
      ins:   0 -> ins x, 1 -> noins 0 (state 0 only), 2 -> noins clamp(x+1)
    where clamp(v) = v if v <= hap_len else RO."""
    i32 = xp.int32
    btf = xp.asarray(btf).astype(i32)
    btb = xp.asarray(btb).astype(i32)
    hl = xp.asarray(hap_len).astype(i32)[None, :, None]
    SP = H_pad + 2
    RO = H_pad + 1
    x = xp.arange(SP, dtype=i32)[None, None, :]

    def fwd(codes):
        cn = codes & 15
        ci = (codes >> 4) & 15
        noins_int = xp.where(cn == 0, SP + xp.maximum(x - 1, 0),
                             xp.where(cn == 1, x,
                                      xp.maximum(x - (cn - 1), 0)))
        noins_ro = xp.where(cn == 0, SP + RO,
                            xp.where(cn == 1, SP + hl,
                                     xp.where(cn == 2, RO, hl)))
        noins = xp.where(x == RO, noins_ro, noins_int)
        ins = xp.where(ci == 0, SP + x, x)
        return xp.concatenate([noins, ins], axis=2).astype(i32)

    def bwd(codes):
        cn = codes & 15
        ci = (codes >> 4) & 15
        y = numT - cn
        xy = x + y
        dely = xp.where(xy <= hl, xy, RO)
        noins = xp.where(cn == 0, SP + x,
                         xp.where(cn == numT, x, dely))
        x1 = xp.where(x + 1 <= hl, x + 1, RO)
        ins = xp.where(ci == 0, SP + x, xp.where(ci == 1, x, x1))
        return xp.concatenate([noins, ins], axis=2).astype(i32)

    return fwd(btf), bwd(btb)


def encode_bt_codes(btf, btb, hap_len, H_pad, numT):
    """The inverse of expand_bt_codes: _dp_xla's full-index backpointers,
    (L, B, 2*S_half), to the kernel's byte class codes, (L, B, S_half)
    uint8, by the same rules the kernel applies to its fold winners.
    A numpy reference for the kernel's storage format, so that _finish
    (bt_codes=True) can be checked against _dp_xla on any host."""
    btf = np.asarray(btf).astype(np.int64)
    btb = np.asarray(btb).astype(np.int64)
    hl = np.asarray(hap_len).astype(np.int64)[None, :, None]
    SP = H_pad + 2
    RO = H_pad + 1
    x = np.arange(SP, dtype=np.int64)[None, None, :]

    def fwd(idx):
        ni, ii = idx[..., :SP], idx[..., SP:]
        cn_int = np.where(ni >= SP, 0, np.where(ni == x, 1, 1 + (x - ni)))
        cn_ro = np.where(ni == RO, 2, np.where(ni == hl, 3,
                                               np.where(ni == SP + RO, 0, 1)))
        cn = np.where(x == RO, cn_ro, cn_int)
        ci = np.where(ii >= SP, 0, 1)
        return (cn | (ci << 4)).astype(np.uint8)

    def bwd(idx):
        ni, ii = idx[..., :SP], idx[..., SP:]
        cn = np.where(ni == SP + x, 0,
                      np.where(ni == x, numT,
                               np.where(ni == RO,
                                        numT - np.maximum(hl + 1 - x, 1),
                                        numT - (ni - x))))
        ci = np.where(ii == SP + x, 0, np.where(x == 0, 1, 2))
        return (cn | (ci << 4)).astype(np.uint8)

    return fwd(btf), bwd(btb)


if __name__ == "__main__":
    import sys
    for plat in (sys.argv[1:] or ["gpu"]):
        print(build(plat))
