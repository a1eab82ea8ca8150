"""Builds the CUDA kernels of ``csrc/`` at first use and loads them.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` -- one process per
source, all started together -- and links the objects into one shared
library with a plain C interface, which ``ctypes`` loads.  The library lands in
``_build/`` beside this package (listed in ``.gitignore``), named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing here runs at import: the first CUDA launch calls
:func:`kernels`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

from ..utils import profiling

__all__ = ["kernels", "check", "plan", "fwd_plan", "bwd_plan", "adaptive_plan", "cluster_plan",
           "build_info", "f32_tiles", "count_f32_tiles", "wide_f32_product"]

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argtypes of each C entry point, in the order of its C signature
_SIGNATURES = {
    "cnf_fused_dynamics_fwd": [_P] * 17 + [_I] * 6 + [_P],
    "cnf_fused_solve_rk4_fwd": [_P] * 16 + [_I] * 10 + [_P],
    "cnf_fused_dynamics_bwd": [_P] * 21 + [_I] * 6 + [_P],
    "cnf_fused_solve_rk4_bwd": [_P] * 21 + [_I] * 10 + [_P],
    "cnf_fused_adaptive_fwd": [_P] * 22 + [_I] * 12 + [_F] * 6 + [_P],
    "cnf_fused_adaptive_bwd": [_P] * 25 + [_I] * 12 + [_F] * 6 + [_P],
    "cnf_plan": [_I] * 6 + [ctypes.POINTER(ctypes.c_int)],
    "cnf_fwd_plan": [_I] * 5 + [ctypes.POINTER(ctypes.c_int)],
    "cnf_bwd_plan": [_I] * 5 + [ctypes.POINTER(ctypes.c_int)],
    "cnf_solve_bwd_plan": [_I] * 6 + [ctypes.POINTER(ctypes.c_int)],
    "cnf_adaptive_plan": [_I] * 6 + [ctypes.POINTER(ctypes.c_int)],
    "cnf_adaptive_cluster_plan": [_I] * 8 + [ctypes.POINTER(ctypes.c_int)],
    "cnf_gates": [_P] * 3 + [_I, _P],
    "cnf_wide_f32_product": [_I, _P, _P, _P, _P],
    "cnf_wide_f32_tally": [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int), _I],
}

# what the last build did: seconds, library path, compiler log
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_nvcc = Path("/usr/local/cuda/bin/nvcc")
    if cuda_nvcc.exists():
        return str(cuda_nvcc)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


@functools.cache
def kernels() -> ctypes.CDLL:
    """Builds (if needed) and loads the kernel library; cached per process."""
    cus, headers = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cus + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib_path = BUILD_DIR / f"libcnf_kernels_{digest.hexdigest()[:16]}.so"
    start = time.perf_counter()
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        objs = [tmp.with_name(f"{tmp.name}.{cu.stem}.o") for cu in cus]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(cu)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cu, obj in zip(cus, objs)
        ]
        outs = [proc.communicate()[0] for proc in procs]
        log = "".join(outs)
        failed = [cu.name for cu, proc in zip(cus, procs) if proc.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            log += link.stdout + link.stderr
            failed = ["link"] if link.returncode != 0 else []
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees a half-written file
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cnf_error_string.argtypes = [ctypes.c_int]
    lib.cnf_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - start, path=str(lib_path), log=log)
    return lib


def check(err: int, what: str) -> None:
    """Raises if a C entry point returned a CUDA error."""
    if err != 0:
        msg = kernels().cnf_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} ({msg})")


class FwdPlan(NamedTuple):
    """K1's and K3's launch shape (:func:`fwd_plan`, :func:`plan`)."""

    rows: int      # rows a block (row path: threads a block, one row each); 0: do not fit
    staged: bool   # weights staged in shared memory
    H: int         # > 0: the row path, hidden width padded to H
    scratch: int   # > 0: the wide path, its scratch floats at this batch

    @property
    def path(self) -> str:
        return "row" if self.H else "wide" if self.scratch else "tiled"


@functools.cache
def fwd_plan(n_in: int, h: int, n_out: int, nz: int, batch: int) -> FwdPlan:
    """K1's launch shape at these widths and batch (``cnf_fwd_plan`` in its
    source).  ``path`` names it: ``"row"`` (h <= 32: one row a thread in
    blocks of ``rows`` threads, hidden width padded to ``H``), ``"wide"``
    (from ``kWideMinH``: a chain of products over the batch, ``rows`` rows
    an output tile, in a scratch of ``scratch`` floats that the wrapper
    allocates) or ``"tiled"`` (``rows`` rows a block)."""
    info = (ctypes.c_int * 3)()
    rows = kernels().cnf_fwd_plan(n_in, h, n_out, nz, batch, info)
    return FwdPlan(rows, bool(info[0]), int(info[1]), int(info[2]))


@functools.cache
def plan(n_in: int, h: int, n_out: int, nz: int, sd: int = 0, batch: int = 1) -> FwdPlan:
    """K3's launch shape at these widths and batch (``sd``: the state width;
    with ``sd = 0`` K1's short of its wide path, which :func:`fwd_plan`
    names; ``cnf_plan`` in K3's source).  ``path`` names it: ``"row"`` (h <=
    32: one row a thread in blocks of ``rows`` threads, hidden width padded
    to ``H``, a multiple of 4), ``"wide"`` (K3 from ``kSolveWideMinH``: the
    solve as a chain of products over the batch, ``rows`` rows an output
    tile, in a scratch of ``scratch`` floats that the wrapper allocates) or
    ``"tiled"`` (``rows`` rows a block)."""
    info = (ctypes.c_int * 3)()
    rows = kernels().cnf_plan(n_in, h, n_out, nz, sd, batch, info)
    return FwdPlan(rows, bool(info[0]), int(info[1]), int(info[2]))


class BwdPlan(NamedTuple):
    """A backward kernel's launch shape (:func:`bwd_plan`)."""

    rows: int      # rows a tile (row path: threads a block, one row each); 0: do not fit
    staged: bool   # weights staged in shared memory
    grid: int      # rows of the (grid, parameter count) partial-sum buffer; 0: none
    n_params: int  # parameter count
    H: int         # > 0: the row path, hidden width padded to H
    scratch: int   # > 0: the wide path, its scratch floats at this batch

    @property
    def path(self) -> str:
        return "row" if self.H else "wide" if self.scratch else "tiled"


@functools.cache
def bwd_plan(n_in: int, h: int, n_out: int, nz: int, sd: int, batch: int) -> BwdPlan:
    """The backward kernels' launch shape (``sd``: the whole-solve kernel's
    state width, 0 for the single stage).  ``path`` names it: ``"row"``
    (K4: h <= 32, K2: h <= 24; one row a thread in blocks of ``rows``
    threads, hidden width padded to ``H``), ``"wide"`` (K2 from
    ``kWideMinH``, K4 from ``kSolveWideMinH``: a chain of products over the
    batch, ``rows`` rows an output tile, in a scratch of ``scratch``
    floats) or ``"tiled"`` (``rows`` rows a tile).  The wrapper allocates
    the ``(grid, n_params)`` buffer of weight-gradient partial sums (per
    block; the wide path's per slice of the batch) and the scratch.  Each
    kernel's source plans its own launch: K2's ``cnf_bwd_plan``, K4's
    ``cnf_solve_bwd_plan``."""
    info = (ctypes.c_int * 5)()
    lib = kernels()
    rows = (lib.cnf_solve_bwd_plan(n_in, h, n_out, nz, sd, batch, info) if sd
            else lib.cnf_bwd_plan(n_in, h, n_out, nz, batch, info))
    return BwdPlan(rows, bool(info[0]), int(info[1]), int(info[2]), int(info[3]), int(info[4]))


@functools.cache
def adaptive_plan(n_in: int, h: int, n_out: int, nz: int, sd: int, group: int):
    """The adaptive kernels' launch shape for a control group of ``group``
    rows: ``(H, rows, smem_fwd, bwd_rows, smem_bwd, walk_H, walk_blocks)``,
    where ``H > 0`` is the row-per-thread path (K5 and K6's replay, hidden
    width padded to ``H``, a multiple of 4) and ``H == 0`` the tiled path with
    ``rows`` rows a stage tile.  K6's walk back: ``walk_H > 0`` is its
    row-per-thread path (hidden width padded to a multiple of 8: padded units
    add exact zeros, so it recomputes K5's stages bit for bit), a kernel of
    its own after the replay (blocks of ``bwd_rows`` threads, one row each),
    ``walk_H == 0`` its tiled path, in the replay's kernel (``bwd_rows`` rows
    a tile); it takes ``walk_blocks`` blocks a group, and the wrapper
    allocates a row of weight-gradient sums for each.  ``smem_bwd``: the
    shared bytes of the kernel that walks.  A byte count of 0 means the
    widths do not fit."""
    info = (ctypes.c_int * 6)()
    smem_fwd = kernels().cnf_adaptive_plan(n_in, h, n_out, nz, sd, group, info)
    return (int(info[0]), int(info[1]), smem_fwd, int(info[2]), int(info[3]), int(info[4]),
            int(info[5]))


class ClusterPlan(NamedTuple):
    """K5's and K6's cluster path (:func:`cluster_plan`)."""

    cluster: int    # CTAs a control group; 0: the path is not taken
    rows: int       # rows of a CTA
    res_fwd: bool   # K5: the weight image resident in shared memory
    state_fwd: bool  # K5: the rows' state in shared memory (else the device scratch)
    smem_fwd: int   # K5: shared bytes of a CTA
    res_bwd: bool   # K6's walk: the weight image resident (its replay holds it as K5 does)
    walk_rows: int  # K6's walk: rows of a pass
    smem_bwd: int   # K6: shared bytes of a CTA
    image: int      # floats of the weight image the wrapper builds (0: none)
    share: int      # floats of a CTA's share of the weight gradient


@functools.cache
def cluster_plan(n_in: int, h: int, n_out: int, nz: int, sd: int, group: int, batch: int,
                 path: int = -1) -> ClusterPlan:
    """The cluster path of K5 and K6 at these widths, groups of ``group`` rows
    and a batch of ``batch`` (``cnf_adaptive_cluster_plan``, from
    ``cluster_plan`` in ``csrc/cluster_adaptive.cuh``): a thread-block
    cluster of ``cluster`` CTAs a group (2 where a CTA's rows fit, else 4),
    each taking ``rows`` of the group's rows in one pass a stage; ``cluster
    == 0`` where the kernels take another path (the row paths, h <= 32; the
    tiled path where the cluster path does not fit).  ``path``: -1 the
    plan's choice, 0 the tiled path (a reference for tests and timings), 1
    the cluster path wherever it fits, 2 or 4 only that many CTAs a group."""
    info = (ctypes.c_int * 9)()
    cluster = kernels().cnf_adaptive_cluster_plan(n_in, h, n_out, nz, sd, group, batch, path, info)
    rows, rf, sf, smf, rb, wr, smb, image, share = (int(v) for v in info)
    return ClusterPlan(int(cluster), rows, bool(rf), bool(sf), smf, bool(rb), wr, smb, image, share)


def f32_tiles() -> Dict[str, int]:
    """Products the library's wide paths have launched in fp32 on each tile
    of their product core since it loaded, by shape: ``{"128x96": n,
    "64x96": n, "64x32": n}`` (``cnf_wide_f32_tally``)."""
    counts, shapes = (ctypes.c_longlong * 8)(), (ctypes.c_int * 16)()
    n = kernels().cnf_wide_f32_tally(counts, shapes, 8)
    return {f"{shapes[2 * i]}x{shapes[2 * i + 1]}": int(counts[i]) for i in range(n)}


def count_f32_tiles(before: Dict[str, int]) -> None:
    """Adds to the counters ``wide.f32.<BMxBN>`` (``utils.profiling``) the
    products launched on each fp32 tile since ``before``, an :func:`f32_tiles`
    reading: a kernel wrapper's call, read on the host."""
    for shape, n in f32_tiles().items():
        if n > before.get(shape, 0):
            profiling.count("wide.f32." + shape, n - before.get(shape, 0))


# an operand of wide_f32_product: (first tensor, its extent, second tensor or
# None, its extent, rows along k)
Operand = Tuple[object, int, Optional[object], int, bool]


def wide_f32_product(tile: int, a: Operand, b: Operand, m: int, n: int, k: int,
                     kseg: int = 1 << 30, slices: int = 1):
    """One fp32 product ``C = A B^T`` of the wide paths' core
    (``csrc/wide_gemm.cuh``) on tile ``tile``, an index of :func:`f32_tiles`'
    shapes (-1: the core's own choice), on the current stream; for the tests
    and ``chip_profile.py wide-f32``, which the port's API does not reach.
    An operand ``(t0, ext0, t1, ext1, kmajor)`` reads element ``(f, k)`` of
    the 2-D fp32 CUDA tensor ``t0`` (``t1`` from depth ``kseg`` on) at ``[f,
    k]`` (kmajor) or ``[k, f]``, 0 past the extent in ``f``.  Returns the
    ``(slices, m, n)`` outputs of the product cut into ``slices`` along k
    (``product()``'s rounding of the count)."""
    import torch

    per = -(-k // slices)
    kslice = -(-per // 64) * 64
    cut = -(-k // kslice)
    out = torch.empty((cut, m, n), dtype=torch.float32, device=a[0].device)
    ptrs = (ctypes.c_void_p * 4)()
    ints = (ctypes.c_int * 15)()
    for i, (t0, e0, t1, e1, kmajor) in enumerate((a, b)):
        t1 = t0 if t1 is None else t1
        ptrs[2 * i], ptrs[2 * i + 1] = t0.data_ptr(), t1.data_ptr()
        ints[5 * i:5 * i + 5] = [t0.stride(0), t1.stride(0), e0, e1, int(kmajor)]
    ints[10:15] = [kseg, m, n, k, slices]
    stream = torch.cuda.current_stream(a[0].device).cuda_stream
    check(kernels().cnf_wide_f32_product(tile, ptrs, ints, out.data_ptr(), stream),
          "wide_f32_product")
    return out
