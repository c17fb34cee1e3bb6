"""Build the hand-written Hopper kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled on first
use with ``nvcc`` into ``build/lib<name>.so`` (rebuilt when the source or a
shared ``csrc/*.cuh`` header is newer than the library), then loaded with
:mod:`ctypes`.  ``ptxas``'s report of each entry's registers and spills
is kept beside the library (``lib<name>.ptxas.txt``) and read by
:meth:`Kernel.resources`.  Sources include no PyTorch header, so a build takes
seconds.  There is no fallback: without ``nvcc``, or when a build fails,
:meth:`Kernel.function` raises ``RuntimeError``.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading

__all__ = ["Kernel", "SWEEP_TILE", "SWEEP_STAGES", "FLOW_TILE",
           "FLOW_HALO", "RESOLVE_TILE", "RESOLVE_HALO", "DIST_TILE",
           "DIST_HALO", "STRAHLER_TILE", "STRAHLER_HALO", "JUMP_TILE",
           "JUMP_THREADS", "SCAN_CLUSTER",
           "SCAN_THREADS", "NVCC_FLAGS",
           "find_nvcc", "ptxas_resources", "stream_handle"]

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

#: Columns owned by one thread block of the fill and accumulation sweeps.
#: Their plain versions take the same value so that a single sweep (stale
#: seams included) is bitwise the kernel's.
SWEEP_TILE = 1024

#: Rows in the shared-memory ring of the fill and accumulation sweeps
#: (``csrc/row_ring.cuh``): how far ahead of the row being swept the input
#: rows are staged.
SWEEP_STAGES = 16

#: Columns of one tile of the D∞ and multi-flow sweeps
#: (``csrc/flow_sweep.cuh``).  Their seams are exact for in-row windows of
#: up to :data:`FLOW_HALO` columns, so the tile width changes only the
#: speed there; at depth 0 the window is the tile, in the plain versions
#: too.  Chosen on an H100 (PERF.md: ``tools/torch_profile.py
#: flow_tiles``).
FLOW_TILE = 128

#: Columns past each edge of a flow-sweep tile that its block stages and
#: takes new values of from its neighbours: in-row windows up to this wide
#: cross tile edges, and a block trades edges every ``FLOW_HALO / window``
#: rows.
FLOW_HALO = 64

#: Columns of one tile of the sweeps on the seam-exact walk
#: (``csrc/seam_walk.cuh``: the resolve, distance and Strahler sweeps), and
#: the columns past each edge that a block stages and takes new values of
#: from its neighbours every ``*_HALO`` rows.  Their seams are exact: one
#: sweep is the sweep over whole rows at every tile width.  Chosen on an
#: H100 (PERF.md: ``tools/torch_profile.py walk_tiles``).
RESOLVE_TILE = 128
RESOLVE_HALO = 64
DIST_TILE = 128
DIST_HALO = 64
STRAHLER_TILE = 128
STRAHLER_HALO = 32

#: Edge of the square tile of the successor jump's local pass
#: (``csrc/successor_jump.cuh``: one block a tile, its cells' targets in
#: shared memory), and the threads of its blocks.  The tile changes only
#: the speed: the result is the fixpoint at every tile.  Chosen on an H100
#: (PERF.md).
JUMP_TILE = 64
JUMP_THREADS = 256

#: The scan fill sweep's cluster (``csrc/fill_scan.cu``): the most CTAs
#: it holds (above 8, a non-portable cluster size) and the most consumer
#: threads a CTA.  The shape never changes the result.  Chosen on an H100
#: (PERF.md: ``tools/torch_profile.py scan_widths``).
SCAN_CLUSTER = 16
SCAN_THREADS = 256

#: Exact IEEE float32: no FMA contraction (plain fill and D8 codes are held
#: bitwise), no fast math.  ``-Xptxas -v`` only reports resources.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", f"-DRD_TILE={SWEEP_TILE}",
              f"-DRD_STAGES={SWEEP_STAGES}", f"-DRD_FLOW_TILE={FLOW_TILE}",
              f"-DRD_FLOW_HALO={FLOW_HALO}",
              f"-DRD_RESOLVE_TILE={RESOLVE_TILE}",
              f"-DRD_RESOLVE_HALO={RESOLVE_HALO}",
              f"-DRD_DIST_TILE={DIST_TILE}", f"-DRD_DIST_HALO={DIST_HALO}",
              f"-DRD_STRAHLER_TILE={STRAHLER_TILE}",
              f"-DRD_STRAHLER_HALO={STRAHLER_HALO}",
              f"-DRD_JUMP_TILE={JUMP_TILE}",
              f"-DRD_JUMP_THREADS={JUMP_THREADS}",
              f"-DRD_SCAN_CLUSTER={SCAN_CLUSTER}",
              f"-DRD_SCAN_THREADS={SCAN_THREADS}"]

#: Where a CUDA toolkit lives when ``CUDA_HOME`` is unset and ``nvcc`` is
#: not on ``PATH``.
DEFAULT_CUDA_HOME = "/usr/local/cuda"


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    default toolkit directory.  Raises ``RuntimeError`` if there is none."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for cand in candidates:
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels cannot be built")


#: One lock a library, held while it is built or loaded, so that entry
#: points of one source never build it twice at once.
_LOCKS = {}
_LOCKS_LOCK = threading.Lock()


class Kernel:
    """One CUDA source, its shared library and its launch counter.

    ``argtypes`` lists the ctypes argument types of the C entry point
    ``symbol``, which returns a ``cudaError_t`` as ``int``.  Two entry
    points of one source are two ``Kernel`` objects of one ``name``, each
    with its own launch count; they share the library and its build.
    ``defines`` (macro → value) replace the build's own ``-D`` values of
    those macros and name a library of their own: a variant built for
    measurement (``tools/torch_profile.py flow_tiles``).  The wrapper
    that launches the kernel calls :meth:`launch`, which adds one to
    ``launches``; nothing else touches the count."""

    def __init__(self, name: str, symbol: str, argtypes, defines=None):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.defines = dict(defines or {})
        self.source = os.path.join(CSRC, f"{name}.cu")
        stem = name + "".join(f"_{k}{v}" for k, v in
                              sorted(self.defines.items()))
        self.library = os.path.join(BUILD, f"lib{stem}.so")
        self.report = os.path.join(BUILD, f"lib{stem}.ptxas.txt")
        self.launches = 0
        self.build_seconds = None
        self._fn = None
        with _LOCKS_LOCK:
            self._lock = _LOCKS.setdefault(self.library, threading.Lock())

    def _stale(self) -> bool:
        """The library is missing, or older than its source or a shared
        header (``csrc/*.cuh``)."""
        if not os.path.exists(self.library):
            return True
        sources = [self.source] + [os.path.join(CSRC, n)
                                   for n in os.listdir(CSRC)
                                   if n.endswith(".cuh")]
        built = os.path.getmtime(self.library)
        return any(os.path.getmtime(s) > built for s in sources)

    def _build(self) -> None:
        """Compile the source into the library; record the seconds taken."""
        import time

        nvcc = find_nvcc()
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{self.library}.{os.getpid()}.tmp"
        flags = [f for f in NVCC_FLAGS if not (
            f.startswith("-D") and f[2:].split("=")[0] in self.defines)]
        flags += [f"-D{k}={v}" for k, v in self.defines.items()]
        cmd = [nvcc, *flags, "-o", tmp, self.source]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source} (rc {proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}")
        with open(self.report, "w", encoding="utf-8") as fh:
            fh.write(proc.stderr + proc.stdout)
        os.replace(tmp, self.library)
        self.build_seconds = time.perf_counter() - t0

    def function(self):
        """The loaded C entry point, building the library if needed.
        ``build_seconds`` stays ``None`` when an up-to-date library was
        loaded without a build."""
        with self._lock:
            if self._fn is None:
                if self._stale():
                    self._build()
                lib = ctypes.CDLL(self.library)
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def entry(self, symbol: str, argtypes):
        """Another C entry point of this kernel's library (built if
        needed), returning an ``int``; it launches nothing and counts no
        launch."""
        self.function()
        fn = getattr(ctypes.CDLL(self.library), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    def resources(self) -> dict:
        """``ptxas``'s report of the last build, by entry function (its
        mangled name): ``registers``, ``spill_stores`` and ``spill_loads``
        (bytes a thread).  Empty when there is no report."""
        if not os.path.exists(self.report):
            return {}
        with open(self.report, encoding="utf-8") as fh:
            return ptxas_resources(fh.read())

    def launch(self, *args) -> None:
        """Call the entry point; raise if it reports a CUDA error."""
        rc = self.function()(*args)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: cudaError {rc}")
        self.launches += 1


def ptxas_resources(text: str) -> dict:
    """Registers and spill bytes of each entry function in the output of
    ``nvcc -Xptxas -v``."""
    out, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry is not None:
            entry["spill_stores"] = int(m.group(1))
            entry["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            entry["registers"] = int(m.group(1))
            entry = None
    return out


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw pointer."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
