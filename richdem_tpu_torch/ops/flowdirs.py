"""Flow directions and flow proportions.

Counterpart of ``richdem_tpu.ops.flowdirs``.  D8 / D4 steepest descent
(``d8_core``, ``d8_flowdirs``) replaces the TPU kernel
``richdem_tpu.ops.pallas_stencils._d8_kernel``: a CUDA tensor goes through
``csrc/d8.cu``, a CPU tensor through the plain shifted-view version
:func:`d8_plain`.  Both follow ``d8_core``: slope by division, off-grid and
nodata neighbours invalid, first maximum in direction order 1..8 with
strict ``>``, ``NO_FLOW`` unless the best slope is > 0,
``FLOWDIR_NO_DATA`` at nodata.  Codes are int8.

Rho8 / Rho4 (``rho8_core``, ``rho8_flowdirs``; Fairfield & Leymarie 1991)
replaces ``pallas_stencils._rho8_kernel``: the same steepest descent with a
random diagonal distance ``1 + tan(u·π/4)`` per cell.  Its random bits come
from Philox4x32-10 keyed by the seed and counting the cell's flat index, in
the kernel (``csrc/rho8.cu``) as on the TPU, and in int64 tensor arithmetic
in the plain version (:func:`philox_bits`), so one seed gives one stream on
every device.  It is not the stream of ``jax.random`` or of the TPU's
``pltpu.prng``: the reference's gates on Rho8 are statistical.

The other metrics are XLA stencils in the reference and plain PyTorch here,
on any device: Tarboton D∞ angles (:func:`dinf_flowdirs`) and the
``(H, W, 8)`` proportions of :func:`flow_proportions` (D8/D4, Rho8/Rho4,
D∞, Quinn, Freeman, Holmgren, Seibert–McGlynn).  Proportions come back as
an ``(H, W, 8)`` view of a plane-major ``(8, H, W)`` stack, the layout the
accumulation sweeps read, so handing them on costs no copy.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from richdem_tpu_torch import topology as topo
from richdem_tpu_torch._build import Kernel, stream_handle
from richdem_tpu_torch.debug import span
from richdem_tpu_torch.ops.stencil import as_tensor, neighbor, nodata_like

__all__ = ["D8", "RHO8", "d8_plain", "d8_core", "d8_flowdirs",
           "stencil_tile_shape",
           "philox_round_keys", "philox4x32", "philox_bits", "rho8_diagonal",
           "rho8_plain", "rho8_core", "rho8_flowdirs",
           "dinf_flowdirs", "proportions_from_dinf", "proportions_from_d8",
           "flow_proportions"]

_P = ctypes.c_void_p
D8 = Kernel("d8", "rd_d8_flowdirs",
            [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, _P])
RHO8 = Kernel("rho8", "rd_rho8_flowdirs",
              [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P,
               ctypes.c_int, _P])

_FLT_MAX = float(np.finfo(np.float32).max)
_INVALID = -3.0e38  # slope of an invalid neighbour


def _directions(topology):
    return (1, 3, 5, 7) if topology == "D4" else tuple(range(1, 9))


def _check_topology(topology):
    if topology not in ("D8", "D4"):
        raise ValueError(f"topology must be 'D8' or 'D4', "
                         f"not {topology!r}")


def _distance(d, cellsize) -> float:
    """float32 ``DR[d] * cellsize``, rounded as the reference rounds it."""
    return float(np.float32(topo.DR[d]) * np.float32(cellsize))


def _steepest_plain(z, nodata_mask, cellsize, topology, diag=None):
    """Codes of the steepest descent, one shifted view per direction; the
    diagonal distance is ``diag * cellsize`` where ``diag`` (an (H, W)
    raster) is given, ``√2 · cellsize`` otherwise."""
    z = z.to(torch.float32)
    big = torch.tensor(_FLT_MAX, dtype=torch.float32, device=z.device)
    zed = torch.where(nodata_mask, big, z)
    best = torch.full_like(z, _INVALID)
    code = torch.zeros(z.shape, dtype=torch.int8, device=z.device)
    cs = torch.tensor(cellsize, dtype=torch.float32, device=z.device)
    for d in _directions(topology):
        zn = neighbor(zed, d, _FLT_MAX)
        if diag is not None and topo.IS_DIAGONAL[d]:
            dist = diag * cs
        else:
            # a device tensor, not a Python scalar: PyTorch's CUDA division
            # by a host scalar multiplies by its reciprocal, which rounds
            # apart
            dist = torch.tensor(_distance(d, cellsize), dtype=torch.float32,
                                device=z.device)
        s = torch.where(zn < big, (z - zn) / dist,
                        torch.tensor(_INVALID, device=z.device))
        take = s > best
        best = torch.where(take, s, best)
        code = torch.where(take, torch.tensor(d, dtype=torch.int8,
                                              device=z.device), code)
    fd = torch.where(best > 0, code, torch.zeros_like(code))
    return torch.where(nodata_mask, torch.full_like(code, -1), fd)


def d8_plain(z, nodata_mask, cellsize=1.0, topology="D8"):
    """Plain version of the D8 kernel: one shifted view per direction."""
    return _steepest_plain(z, nodata_mask, cellsize, topology)


def _stencil_inputs(z, nodata_mask):
    """``z`` and its mask, checked and contiguous, for a stencil kernel."""
    if z.dim() != 2 or z.dtype != torch.float32:
        raise ValueError(f"z: expected a 2-D float32 tensor, got {z.dtype} "
                         f"{tuple(z.shape)}")
    if (nodata_mask.dtype != torch.bool or nodata_mask.shape != z.shape
            or nodata_mask.device != z.device):
        raise ValueError("nodata_mask must be a bool tensor shaped and "
                         "placed like z")
    return z.contiguous(), nodata_mask.contiguous()


def d8_core(z, nodata_mask, cellsize=1.0, topology="D8"):
    """D8/D4 codes (int8) of ``z`` with its nodata mask.  A CUDA tensor
    launches ``csrc/d8.cu`` (raising if it cannot be built or launched); a
    CPU tensor runs :func:`d8_plain`."""
    with span("rd.d8"):
        _check_topology(topology)
        if not z.is_cuda:
            return d8_plain(z, nodata_mask, cellsize, topology)
        z, nodata_mask = _stencil_inputs(z, nodata_mask)
        h, w = z.shape
        out = torch.empty(z.shape, dtype=torch.int8, device=z.device)
        if h == 0 or w == 0:
            return out
        D8.launch(z.data_ptr(), nodata_mask.data_ptr(), out.data_ptr(), h, w,
                  _distance(1, cellsize), _distance(2, cellsize),
                  int(topology == "D4"), stream_handle(z.device))
        return out


def stencil_tile_shape():
    """The shared-memory tile (``csrc/stencil_tile.cuh``) on which D8, Rho8
    and terrain run, read through D8's library (built if needed): tile
    ``rows`` and ``cols``, ``threads`` a block, and the cells a thread
    computes (``cell_rows`` × ``cell_cols``)."""
    out = (ctypes.c_int * 5)()
    D8.entry("rd_stencil_tile_shape", [ctypes.c_void_p])(out)
    return dict(zip(("rows", "cols", "threads", "cell_rows", "cell_cols"),
                    out))


def d8_flowdirs(dem, no_data=None, topology="D8", cellsize=1.0,
                device="cuda"):
    """Steepest-descent single flow directions of a DEM: a tensor (the
    work runs where it lives) or an array (moved to ``device``)."""
    dem = as_tensor(dem, device)
    return d8_core(dem.to(torch.float32), nodata_like(dem, no_data),
                   cellsize, topology)


# -- Rho8 -----------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
#: Philox4x32 multipliers and Weyl key increments (Salmon et al. 2011)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10


def _mulhilo(m, x):
    """High and low 32-bit words of ``m * x`` for a 32-bit constant ``m``
    and uint32 values ``x`` held in int64, without overflowing int64: ``m``
    is split into 16-bit halves, so every partial product is below 2⁴⁹."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox_round_keys(seed):
    """The ``(k0, k1)`` key of each of the 10 rounds of Philox4x32-10 keyed
    by the low 64 bits of ``seed``: the same for every counter, so the
    kernel takes them from the host."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    keys = []
    for _ in range(PHILOX_ROUNDS):
        keys.append((k0, k1))
        k0, k1 = (k0 + PHILOX_W[0]) & _MASK32, (k1 + PHILOX_W[1]) & _MASK32
    return tuple(keys)


def philox4x32(counter, seed):
    """Philox4x32-10 of the four uint32 counter words (int64 tensors of one
    shape), keyed by the low 64 bits of ``seed``; returns the four output
    words."""
    c0, c1, c2, c3 = counter
    for k0, k1 in philox_round_keys(seed):
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(shape, seed, device):
    """32 random bits per cell (int64): the first word of Philox4x32-10 of
    the counter (flat index, 0, 0, 0) under ``seed``, as ``csrc/rho8.cu``
    draws them."""
    h, w = shape
    idx = torch.arange(h * w, dtype=torch.int64, device=device).view(h, w)
    zero = torch.zeros_like(idx)
    return philox4x32((idx & _MASK32, idx >> 32, zero, zero), seed)[0]


def rho8_diagonal(shape, seed, device):
    """The random diagonal distance ``1 + tan(u·π/4)`` per cell, float32,
    with ``u = (bits & 0xFFFFFF)·2⁻²⁴`` from :func:`philox_bits` (the TPU
    kernel's ``u``; ``1 + tan`` is the reference's)."""
    bits = philox_bits(shape, seed, device)
    u = (bits & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
    quarter = torch.tensor(math.pi / 4.0, dtype=torch.float32, device=device)
    return 1.0 + torch.tan(u * quarter)


def rho8_plain(z, nodata_mask, cellsize, diag, topology="D8"):
    """Plain Rho8 core with the diagonal-distance raster ``diag`` given:
    ``ops.flowdirs._neighbor_slopes(diag_dist=diag)`` and ``_steepest``
    of the reference (slope by division, first maximum, strict ``>``)."""
    return _steepest_plain(z, nodata_mask, cellsize, topology, diag)


def rho8_core(z, nodata_mask, cellsize=1.0, seed=0, topology="D8"):
    """Rho8 / Rho4 codes (int8) of ``z`` with its nodata mask.  A CUDA
    tensor launches ``csrc/rho8.cu``, which draws the random bits in the
    kernel (raising if it cannot be built or launched); a CPU tensor runs
    :func:`rho8_plain` on :func:`rho8_diagonal`, the same stream."""
    _check_topology(topology)
    if not z.is_cuda:
        diag = rho8_diagonal(z.shape, seed, z.device)
        return rho8_plain(z, nodata_mask, cellsize, diag, topology)
    z, nodata_mask = _stencil_inputs(z, nodata_mask)
    h, w = z.shape
    out = torch.empty(z.shape, dtype=torch.int8, device=z.device)
    if h == 0 or w == 0:
        return out
    keys = [k for pair in philox_round_keys(seed) for k in pair]
    RHO8.launch(z.data_ptr(), nodata_mask.data_ptr(), out.data_ptr(), h, w,
                float(np.float32(cellsize)),
                (ctypes.c_uint32 * len(keys))(*keys), int(topology == "D4"),
                stream_handle(z.device))
    return out


def _no_key(key):
    """The reference's ``key`` (a ``jax.random`` key) has its place in the
    signature; the port draws from ``seed`` and cannot take one."""
    if key is not None:
        raise ValueError(
            "key: the port draws Rho8's stream from seed (Philox4x32-10) and "
            "cannot reproduce jax.random keys; pass key=None and a seed")


def rho8_flowdirs(dem, no_data=None, key=None, seed=0, topology="D8",
                  cellsize=1.0, device="cuda"):
    """Stochastic aspect-unbiased single flow directions (Fairfield &
    Leymarie 1991): the diagonal wins with the probability that its true
    direction deserves.  ``seed`` keys the random stream; ``key`` stands
    where the reference takes a JAX key and must be ``None``
    (``ValueError`` otherwise).  ``dem``: a tensor (the work runs where it
    lives) or an array (moved to ``device``)."""
    _no_key(key)
    dem = as_tensor(dem, device)
    return rho8_core(dem.to(torch.float32), nodata_like(dem, no_data),
                     cellsize, seed, topology)


# -- multi-flow metrics (plain PyTorch, as XLA in the reference) ---------

def _neighbor_slopes(z, nodata_mask, cellsize, dirs):
    """(len(dirs), H, W) slopes toward each direction, ``-3e38`` where the
    neighbour is off-grid or nodata (``ops.flowdirs._neighbor_slopes``)."""
    compute = z.to(torch.float32) if z.dtype == torch.float16 else z
    big = torch.tensor(_FLT_MAX, dtype=compute.dtype, device=z.device)
    neg = torch.tensor(_INVALID, dtype=compute.dtype, device=z.device)
    zed = torch.where(nodata_mask, big, compute)
    cs = torch.tensor(cellsize, dtype=torch.float32, device=z.device)
    slopes = torch.empty((len(dirs),) + tuple(z.shape), dtype=compute.dtype,
                         device=z.device)
    for i, d in enumerate(dirs):
        zn = neighbor(zed, d, _FLT_MAX)
        dist = torch.tensor(topo.DR[d], dtype=compute.dtype,
                            device=z.device) * cs
        torch.where(zn < big, (compute - zn) / dist, neg, out=slopes[i])
    return slopes


def _as_props(planes):
    """The ``(H, W, 8)`` view of a plane-major ``(8, H, W)`` stack."""
    return planes.permute(1, 2, 0)


def _mfd_impl(z, nodata_mask, cellsize, exponent):
    """Slope-weighted multi-flow proportions: share toward d ∝
    ``max(slope_d, 0) ** exponent`` (Quinn 1991 at 1, Freeman 1991 at
    1.1, Holmgren 1994).  The reference's ``where``s, worked in place on
    the one (8, H, W) stack: for ``exponent`` > 0 a zero slope weighs 0 and
    a zero total leaves 0/1e-30 = 0."""
    if exponent <= 0:
        raise ValueError(f"exponent must be > 0, not {exponent}")
    wts = _neighbor_slopes(z, nodata_mask, cellsize, range(1, 9))
    wts.clamp_(min=0.0).pow_(exponent)
    tiny = torch.tensor(1e-30, dtype=wts.dtype, device=wts.device)
    planes = wts.div_(torch.maximum(wts.sum(0), tiny))
    planes.masked_fill_(nodata_mask, 0.0)
    return _as_props(planes.to(torch.float64 if z.dtype == torch.float64
                               else torch.float32))


# (e1, e2, ac, af) facet table of the reference (the oracle's _DINF_FACETS)
_FACETS = ((5, 4, 0, 1), (3, 4, 1, -1), (3, 2, 1, 1), (1, 2, 2, -1),
           (1, 8, 2, 1), (7, 8, 3, -1), (7, 6, 3, 1), (5, 6, 4, -1))


def _facets(z, nodata_mask, cellsize):
    """Per facet ``(e1, e2, ac, af, ok, rr, ss, rmax)`` of the Tarboton
    triangles around each cell: ``rr`` the in-facet angle clipped to
    ``[0, rmax]``, ``ss`` its slope, ``ok`` whether either facet
    neighbour is data.  Off-grid and nodata neighbours degrade as in the
    reference (a missing e1 to the centre, a missing e2 to e1)."""
    compute = z.to(torch.float64 if z.dtype == torch.float64
                   else torch.float32)
    d1 = torch.tensor(cellsize, dtype=torch.float32,
                      device=z.device).to(compute.dtype)
    rmax = torch.atan2(d1, d1)
    diag = torch.sqrt(d1 * d1 + d1 * d1)
    zed = torch.where(nodata_mask, torch.tensor(math.nan, dtype=compute.dtype,
                                                device=z.device), compute)
    for e1, e2, ac, af in _FACETS:
        z1 = neighbor(zed, e1, math.nan)
        z2 = neighbor(zed, e2, math.nan)
        ok1, ok2 = ~torch.isnan(z1), ~torch.isnan(z2)
        z1v = torch.where(ok1, z1, compute)
        z2v = torch.where(ok2, z2, z1v)
        s1 = (compute - z1v) / d1
        s2 = (z1v - z2v) / d1
        r = torch.atan2(s2, s1)
        rr = torch.clamp(r, min=0.0).minimum(rmax)
        ss = torch.where(r < 0.0, s1,
                         torch.where(r > rmax, (compute - z2v) / diag,
                                     torch.sqrt(s1 * s1 + s2 * s2)))
        yield e1, e2, ac, af, ok1 | ok2, rr, ss, rmax


def _dinf_impl(z, nodata_mask, cellsize):
    """Tarboton (1997) D∞ angles: the steepest facet's direction, radians
    counter-clockwise from East; -1 NO_FLOW, -2 nodata.  The first facet
    wins ties (strict ``>``, as the oracle)."""
    best_s = best_a = None
    for e1, e2, ac, af, ok, rr, ss, _ in _facets(z, nodata_mask, cellsize):
        if best_s is None:
            best_s = torch.zeros_like(ss)
            best_a = torch.full_like(ss, -1.0)
        ss = torch.where(ok, ss, -math.inf)
        ang = af * rr + ac * (math.pi / 2.0)
        take = ss > best_s
        best_a = torch.where(take, ang, best_a)
        best_s = torch.where(take, ss, best_s)
    # the reference's floor modulo (``%``), not fmod
    out = torch.where(best_a == -1.0, best_a,
                      torch.remainder(best_a, 2.0 * math.pi))
    out = torch.where(best_s > 0.0, out, -1.0)
    return torch.where(nodata_mask, -2.0, out)


def _seibert_impl(z, nodata_mask, cellsize, exponent):
    """Triangular multi-flow MD∞ (Seibert & McGlynn 2007): each facet with
    a positive slope sends ``slope ** exponent``, split between its two
    directions by the in-facet angle."""
    shares = None
    for e1, e2, ac, af, ok, rr, ss, rmax in _facets(z, nodata_mask,
                                                    cellsize):
        if shares is None:
            shares = torch.zeros((8,) + tuple(ss.shape), dtype=ss.dtype,
                                 device=ss.device)
        zero = torch.zeros((), dtype=ss.dtype, device=ss.device)
        weight = torch.where(ok & (ss > 0.0), ss ** exponent, zero)
        frac2 = rr / rmax
        shares[e1 - 1] += weight * (1.0 - frac2)
        shares[e2 - 1] += weight * frac2
    total = shares.sum(0)
    zero = torch.zeros((), dtype=shares.dtype, device=shares.device)
    tiny = torch.tensor(1e-30, dtype=shares.dtype, device=shares.device)
    planes = torch.where(total > 0, shares / torch.maximum(total, tiny),
                         zero)
    return _as_props(torch.where(nodata_mask, zero, planes))


def dinf_flowdirs(dem, no_data=None, cellsize=1.0, device="cuda"):
    """Continuous flow angles, radians counter-clockwise from East
    (Tarboton 1997); -1 NO_FLOW, -2 nodata.  ``dem``: a tensor (the work
    runs where it lives) or an array (moved to ``device``)."""
    with span("rd.dinf_dirs"):
        z = as_tensor(dem, device)
        return _dinf_impl(z, nodata_like(z, no_data), cellsize)


#: D8 code at angle k·π/4: E, NE, N, NW, W, SW, S, SE
OCTANT_DIRS = (5, 4, 3, 2, 1, 8, 7, 6)


def octants_per_radian(a):
    """``1 / (π/4)`` in ``a``'s dtype, a device scalar: angles become
    octants by this product, which is what XLA makes of the reference's
    division by the constant π/4 (a true division rounds some angles to
    the other side of an octant edge)."""
    quarter = np.asarray(math.pi / 4.0, dtype=str(a.dtype).removeprefix(
        "torch."))
    return torch.tensor(np.reciprocal(quarter), device=a.device)


def proportions_from_dinf(angles):
    """(H, W, 8) proportions of a D∞ angle raster: the flow splits between
    the two D8 directions that bracket the angle."""
    a = angles
    q = a * octants_per_radian(a)
    k = torch.remainder(torch.floor(q).long(), 8)
    frac = q - torch.floor(q)
    octants = torch.tensor(OCTANT_DIRS, device=a.device)
    d_lo, d_hi = octants[k], octants[(k + 1) % 8]
    flowing = a >= 0.0
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    lo = torch.where(flowing, 1.0 - frac, zero)
    hi = torch.where(flowing, frac, zero)
    planes = torch.stack([(d_lo == d).to(a.dtype) * lo
                          + (d_hi == d).to(a.dtype) * hi
                          for d in range(1, 9)])
    return _as_props(planes)


def proportions_from_d8(flowdirs):
    """One-hot (H, W, 8) proportions of a D8 raster (NO_FLOW and nodata
    send nothing)."""
    fd = flowdirs
    return _as_props(torch.stack([(fd == d).to(torch.float32)
                                  for d in range(1, 9)]))


def flow_proportions(dem, method="D8", no_data=None, exponent=None,
                     cellsize=1.0, key=None, seed=0, device="cuda"):
    """(H, W, 8) proportions of any metric, the counterpart of pyrichdem's
    ``FlowProportions``.  ``dem``: a tensor (the work runs where it lives)
    or an array (moved to ``device``).  ``seed`` keys Rho8's stream;
    ``key`` must be ``None``, as in :func:`rho8_flowdirs`."""
    with span("rd.props"):
        _no_key(key)
        z = as_tensor(dem, device)
        m = method.lower()
        if m in ("d8", "ocallaghan", "d4"):
            topology = "D4" if m == "d4" else "D8"
            return proportions_from_d8(d8_flowdirs(z, no_data, topology,
                                                   cellsize))
        if m in ("rho8", "rho4"):
            topology = "D4" if m == "rho4" else "D8"
            return proportions_from_d8(rho8_flowdirs(z, no_data, seed=seed,
                                                     topology=topology,
                                                     cellsize=cellsize))
        if m in ("dinf", "tarboton"):
            return proportions_from_dinf(dinf_flowdirs(z, no_data, cellsize))
        mask = nodata_like(z, no_data)
        if m == "quinn":
            return _mfd_impl(z, mask, cellsize, 1.0)
        if m == "freeman":
            return _mfd_impl(z, mask, cellsize,
                             1.1 if exponent is None else float(exponent))
        if m == "holmgren":
            if exponent is None:
                raise ValueError("Holmgren requires an exponent")
            return _mfd_impl(z, mask, cellsize, float(exponent))
        if m in ("seibertmcglynn", "md_infinity", "mdinf"):
            return _seibert_impl(z, mask, cellsize,
                                 1.0 if exponent is None else float(exponent))
        raise ValueError(f"unknown flow metric: {method!r}")
