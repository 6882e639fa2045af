import os
import subprocess
import sys
from pathlib import Path

import pytest

# The suite runs on CPU with x64 and 8 virtual devices for the sharding
# tests.  The card-only tests (marker "chip") need the GPU instead:
# chip_smoke.py runs them with DINDEL_TESTS_ON_CHIP=1, which leaves the
# platform alone.  Whether a card is present is decided per test, in the
# `gpu` fixture below, never at import.
ON_CHIP = os.environ.get("DINDEL_TESTS_ON_CHIP") == "1"
if not ON_CHIP:
    os.environ["JAX_PLATFORMS"] = "cpu"
    prev = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in prev:
        os.environ["XLA_FLAGS"] = (
            prev + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_CHIP:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from dindel_tpu import compile_cache  # noqa: E402

# CPU tests keep their own cache subdirectory: bit-equality assertions
# compare fresh and cached executables, so entries must come from CPU
# compiles on this host.  Child processes the tests spawn share it.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      compile_cache.enable("cpu-tests" if not ON_CHIP
                                           else ""))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a GPU; run on the card by chip_smoke.py "
                   "(DINDEL_TESTS_ON_CHIP=1 python -m pytest -m chip tests/)")


@pytest.fixture
def gpu():
    """The GPU device; skips the test where JAX finds none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (runs on the card through chip_smoke.py)")
    return dev


REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

REFSHIM = REPO / "native" / "refshim"
REF_HMM = REFSHIM / "ref_hmm"
REF_NW = REFSHIM / "ref_nw"


def _build(target: str, sources, extra=()):
    exe = REFSHIM / target
    srcs = [str(s) for s in sources]
    newest = max(os.path.getmtime(s) for s in srcs if os.path.exists(s))
    if exe.exists() and os.path.getmtime(exe) > newest:
        return exe
    cmd = ["g++", "-O2", "-std=c++11", "-Wno-deprecated",
           "-include", str(REFSHIM / "stringhash_preempt.h"),
           "-I", str(REFSHIM), "-I", "/root/reference",
           *extra, *srcs, "-o", str(exe)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    return exe


def ref_hmm_exe():
    """Build (if possible) the reference-HMM differential driver."""
    if not Path("/root/reference/ObservationModelFB.cpp").exists():
        return None
    return _build("ref_hmm", [REFSHIM / "hmm_driver.cpp",
                              "/root/reference/ObservationModelFB.cpp"])


def ref_hapgen_exe():
    """Build (if possible) the reference haplotype-generation differential
    driver (HaplotypeDistribution + HDIterator2)."""
    if not Path("/root/reference/HaplotypeDistribution.cpp").exists():
        return None
    return _build("ref_hapgen", [REFSHIM / "hapgen_driver.cpp",
                                 "/root/reference/HaplotypeDistribution.cpp",
                                 "/root/reference/HapBlock.cpp"])


def ref_callers_exe():
    """Build (if possible) the reference diploid/pooled-caller differential
    driver (compiles the whole DInDel.cpp behind stub bam/boost headers)."""
    if not Path("/root/reference/DInDel.cpp").exists():
        return None
    return _build(
        "ref_callers",
        [REFSHIM / "callers_driver.cpp", REFSHIM / "refshim_defs.cpp",
         "/root/reference/DInDel.cpp",
         "/root/reference/ObservationModelFB.cpp",
         "/root/reference/HaplotypeDistribution.cpp",
         "/root/reference/HapBlock.cpp", "/root/reference/Faster.cpp"],
        extra=["-w", "-fpermissive", "-I", "/root/reference/seqan_library"])


def ref_getreads_exe():
    """Build (if possible) the DetInDel::getReads differential driver
    (whole DInDel.cpp behind the stub headers, with the bam.h fetch hook
    replaying synthetic bam1_t records)."""
    if not Path("/root/reference/DInDel.cpp").exists():
        return None
    return _build(
        "ref_getreads",
        [REFSHIM / "getreads_driver.cpp", REFSHIM / "refshim_defs.cpp",
         "/root/reference/DInDel.cpp",
         "/root/reference/ObservationModelFB.cpp",
         "/root/reference/HaplotypeDistribution.cpp",
         "/root/reference/HapBlock.cpp", "/root/reference/Faster.cpp"],
        extra=["-w", "-fpermissive", "-I", "/root/reference/seqan_library"])


def ref_window_exe():
    """Build (if possible) the composed whole-window differential driver
    (reference detectIndels end-to-end over synthetic bam1_t streams).

    -ftrivial-auto-var-init=zero + the driver's zeroing operator new pin
    the reference's uninitialized-memory UB (e.g. the --faster path's
    never-written MLAlignment stat fields, MLAlignment.hpp:35-48) to the
    defined-behavior zero subset our port implements."""
    if not Path("/root/reference/DInDel.cpp").exists():
        return None
    return _build(
        "ref_window",
        [REFSHIM / "window_driver.cpp", REFSHIM / "refshim_defs.cpp",
         "/root/reference/DInDel.cpp",
         "/root/reference/ObservationModelFB.cpp",
         "/root/reference/HaplotypeDistribution.cpp",
         "/root/reference/HapBlock.cpp", "/root/reference/Faster.cpp"],
        extra=["-w", "-fpermissive", "-ftrivial-auto-var-init=zero",
               "-I", "/root/reference/seqan_library"])


def ref_faster_exe():
    """Build (if possible) the reference sparse-HMM (--faster)
    differential driver."""
    if not Path("/root/reference/Faster.cpp").exists():
        return None
    return _build("ref_faster", [REFSHIM / "faster_driver.cpp",
                                 "/root/reference/Faster.cpp"])


def ref_nw_exe():
    """Build (if possible) the reference-SeqAn-NW differential driver."""
    if not Path("/root/reference/seqan_library").exists():
        return None
    exe = REFSHIM / "ref_nw"
    src = REFSHIM / "nw_driver.cpp"
    if not src.exists():
        return None
    if exe.exists() and os.path.getmtime(exe) > os.path.getmtime(src):
        return exe
    cmd = ["g++", "-O2", "-std=c++11", "-fpermissive", "-w",
           "-include", str(REFSHIM / "stringhash_preempt.h"),
           "-I", str(REFSHIM), "-I", "/root/reference",
           "-I", "/root/reference/seqan_library",
           str(src), "-o", str(exe)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    return exe
