"""Public API — name-compatible with pyrichdem (SURVEY.md §2.5), the
port's counterpart of ``richdem_tpu.api``.

A RichDEM user switches the import and keeps their script:

    import richdem_tpu_torch as rd
    dem = rd.LoadGDAL("dem.tif")          # GDAL-free loader underneath
    rd.FillDepressions(dem, epsilon=True, in_place=True)
    accum = rd.FlowAccumulation(dem, method="Dinf")
    slope = rd.TerrainAttribute(dem, attrib="slope_riserun")

Same names, defaults, ``PROCESSING_HISTORY`` lines and nodata conventions
as the reference.  Where it runs: an ``rdarray`` holding a tensor computes
where the tensor lives; one holding an array (what the loaders return)
computes on the card (:meth:`rdarray.tensor`).  Results hold tensors on
that device, except the host ops (``BreachDepressions``, the default
Orlandini engine), which return arrays as in the reference.

Differences from the reference, each deliberate:

* the fill runs the reference's TPU engines on every device (the folded
  sweeps, or the scan sweeps under ``RICHDEM_TPU_FILL_ENGINE=scan``), in
  float32; ``topology="D4"`` prices diagonal edges out at ``BIG / 2``, the
  reference's TPU semantics (its CPU path runs a min-plus fixpoint at cost
  ``BIG``, where an off-grid ``-BIG + BIG`` cancels to 0);
* ``BreachDepressions`` runs the port's native engine and raises if it
  cannot be built: there is no Python oracle fallback;
* the ``seed`` of the Rho8 methods keys the port's Philox stream, not
  JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from richdem_tpu_torch import io as rio
from richdem_tpu_torch import methods as _methods
from richdem_tpu_torch.grid import rd3array, rdarray
from richdem_tpu_torch.ops import accum as _accum
from richdem_tpu_torch.ops import fill as _fill
from richdem_tpu_torch.ops import flats as _flats
from richdem_tpu_torch.ops import flowdirs as _flowdirs
from richdem_tpu_torch.ops import terrain as _terrain
from richdem_tpu_torch.ops.stencil import nodata_like
from richdem_tpu_torch.ops.sweeps import BIG
from richdem_tpu_torch.provenance import add_history, cite
from richdem_tpu_torch.topology import FLOWDIR_NO_DATA

__all__ = [
    "rdarray", "rd3array", "LoadGDAL", "SaveGDAL", "FillDepressions",
    "BreachDepressions", "ResolveFlats", "FlowProportions",
    "FlowAccumulation", "FlowAccumFromProps", "TerrainAttribute",
    "FlowDirections", "WatershedLabels", "UpslopeCells", "StrahlerOrder",
    "TWI", "SPI", "rdCompare", "rdShow",
]


def _as_rd(dem) -> rdarray:
    if isinstance(dem, rdarray):
        return dem
    return rdarray(dem if torch.is_tensor(dem) else np.asarray(dem))


def _on(x, device):
    """``x`` (a tensor, an ``rdarray`` or an array) as a tensor on
    ``device``: a second operand goes where the first one computes."""
    if isinstance(x, rdarray):
        return x.tensor(device)
    if torch.is_tensor(x):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _result(src_rd, data, call, no_data=None):
    out = src_rd.like(data)
    if no_data is not None:
        out.no_data = no_data
    add_history(out, call)
    return out


# -- IO -----------------------------------------------------------------

def LoadGDAL(filename, no_data=None) -> rdarray:
    """Load a raster (GeoTIFF/.npz/.asc).  Name kept for pyrichdem
    compatibility; no GDAL underneath."""
    rd = rio.load(filename)
    if no_data is not None:
        rd.no_data = no_data
    return rd


def SaveGDAL(filename, rdarray_in):
    """Save a raster (GeoTIFF/.npz/.asc), embedding PROCESSING_HISTORY."""
    return rio.save(filename, _as_rd(rdarray_in))


# -- hydrological conditioning -----------------------------------------

def FillDepressions(dem, epsilon=False, in_place=False, topology="D8",
                    max_iters=1024):
    """Depression filling (device sweep fixpoint == Priority-Flood).

    ``epsilon``: False → plain fill; True → auto epsilon; a float → that
    epsilon per step.  The engine is ``RICHDEM_TPU_FILL_ENGINE``'s."""
    cite("priority_flood")
    rd = _as_rd(dem)
    if topology not in ("D8", "D4"):
        raise ValueError("topology must be 'D8' or 'D4'")
    z = rd.tensor()
    if epsilon is True:
        eps = _fill.auto_epsilon(z)
    elif epsilon is False:
        eps = 0.0
    else:
        eps = float(epsilon)
    # D4 = the fill sweep with diagonal edges priced out.  BIG/2 (not BIG)
    # so the off-grid boundary injection -BIG + eps_diag stays hugely
    # negative instead of cancelling to 0.
    eps_diag = BIG / 2 if topology == "D4" else None
    filled = _fill.fill_depressions(z, no_data=rd.no_data, eps=eps,
                                    max_iters=max_iters, eps_diag=eps_diag)
    call = (f"FillDepressions(dem, epsilon={epsilon!r}, "
            f"topology={topology!r})")
    if in_place:
        rd.data = filled
        return add_history(rd, call)
    return _result(rd, filled, call)


def BreachDepressions(dem, in_place=False, mode="Complete", eps=0.0,
                      max_path_len=None, max_path_depth=None,
                      fill_remainder=False):
    """Depression breaching (Lindsay 2016) — a host op by design: the
    carving walk is inherently path-sequential (SURVEY.md §7 hard-part 5)
    and is serial C++ in the reference too.  Runs on the port's native
    engine when it builds, else on the Python oracle
    (:mod:`richdem_tpu_torch.oracle.breach`); both give the same bits."""
    cite("breach")
    rd = _as_rd(dem)
    from richdem_tpu_torch import native
    from richdem_tpu_torch.oracle import breach as _breach_oracle
    impl = (native.breach_depressions if native.available()
            else _breach_oracle.breach_depressions)
    out = impl(
        rd.np(), no_data=rd.no_data, mode=mode, eps=eps,
        max_path_len=max_path_len, max_path_depth=max_path_depth,
        fill_remainder=fill_remainder)
    call = f"BreachDepressions(dem, mode={mode!r})"
    if in_place:
        rd.data = out
        return add_history(rd, call)
    return _result(rd, out, call)


def ResolveFlats(dem, in_place=False):
    """Impose drainage on flats (BLM 2014) by applying the integer
    ``flat_mask`` as resolvable elevation increments, so that subsequent
    D8 flow directions drain every flat."""
    cite("flat_resolution")
    rd = _as_rd(dem)
    z = rd.tensor()
    fd = _flowdirs.d8_flowdirs(z, no_data=rd.no_data)
    mask, _ = _flats.flat_mask_and_labels_device(z, fd, no_data=rd.no_data)
    # Increment small enough to never disturb non-flat ordering, large
    # enough to survive the dtype's ulp at the terrain's scale.
    finite = torch.isfinite(z)
    scale = max(float(torch.where(finite, torch.abs(z), 0).max()), 1.0)
    eps = float(torch.finfo(z.dtype if z.is_floating_point()
                            else torch.float64).eps)
    delta = eps * scale * 4.0
    altered = z + mask.to(z.dtype) * torch.tensor(delta, dtype=z.dtype,
                                                  device=z.device)
    call = "ResolveFlats(dem)"
    if in_place:
        rd.data = altered
        return add_history(rd, call)
    return _result(rd, altered, call)


# -- flow ----------------------------------------------------------------

def FlowDirections(dem, method="D8", exponent=None, seed=0,
                   engine="host"):
    """D8/D4/Rho8 single-flow direction raster, or Dinf angle raster.

    ``engine`` applies to Orlandini only: ``"host"`` (default — the
    serial oracle, as the reference's serial C++) or ``"device"`` (the
    deviation-field fixpoint in ops/orlandini.py — identical output,
    O(longest-flow-path) Jacobi iterations)."""
    cite(method)
    rd = _as_rd(dem)
    z = rd.tensor()
    m = method.lower()
    if m in ("d8", "d4", "ocallaghan"):
        out = _flowdirs.d8_flowdirs(z, no_data=rd.no_data,
                                    topology="D4" if m == "d4" else "D8",
                                    cellsize=rd.cellsize)
    elif m in ("rho8", "rho4"):
        out = _flowdirs.rho8_flowdirs(z, no_data=rd.no_data, seed=seed,
                                      topology="D4" if m == "rho4" else "D8",
                                      cellsize=rd.cellsize)
    elif m in ("dinf", "tarboton"):
        out = _flowdirs.dinf_flowdirs(z, no_data=rd.no_data,
                                      cellsize=rd.cellsize)
    elif m in ("orlandini", "d8ltd", "d8lad"):
        # Path-sequential by construction (deviation state rides the
        # flow path).  Default = host oracle, exactly as it is serial
        # C++ in the reference (SURVEY.md §2.2 Orlandini row); the
        # device fixpoint is available via engine="device".
        lam = 1.0 if exponent is None else float(exponent)
        mode = "LAD" if m == "d8lad" else "LTD"
        if engine == "device":
            from richdem_tpu_torch.ops.orlandini import \
                orlandini_flowdirs_device
            out = orlandini_flowdirs_device(
                z, no_data=rd.no_data, lam=lam, mode=mode,
                cellsize=rd.cellsize)
        else:
            from richdem_tpu_torch.oracle.orlandini import \
                orlandini_flowdirs
            out = orlandini_flowdirs(
                rd.np(), no_data=rd.no_data, lam=lam, mode=mode,
                cellsize=rd.cellsize)
    else:
        raise ValueError(f"unknown flow-direction method {method!r}")
    res = _result(rd, out, f"FlowDirections(dem, method={method!r})")
    res.no_data = float(FLOWDIR_NO_DATA) if m not in (
        "dinf", "tarboton") else -2.0
    return res


def FlowProportions(dem, method="D8", exponent=None, seed=0) -> rd3array:
    """(H, W, 8) outflow proportions for any supported metric."""
    cite(method)
    rd = _as_rd(dem)
    props = _flowdirs.flow_proportions(rd.tensor(), method=method,
                                       no_data=rd.no_data, exponent=exponent,
                                       cellsize=rd.cellsize, seed=seed)
    out = rd3array(props, no_data=0.0, geotransform=rd.geotransform,
                   projection=rd.projection, metadata=dict(rd.metadata))
    add_history(out, f"FlowProportions(dem, method={method!r}, "
                f"exponent={exponent!r})")
    return out


def FlowAccumFromProps(props, weights=None):
    """Weighted upstream accumulation from an (H, W, 8) proportions
    raster (the topological pass on a card, the multi-flow sweeps on the
    CPU or where the shares hold a cycle)."""
    rd = props if isinstance(props, rdarray) else rd3array(
        props if torch.is_tensor(props) else np.asarray(props))
    p = rd.tensor()
    w = None if weights is None else _on(weights, p.device)
    acc = _accum.flow_accumulation_from_props(p, weights=w)
    out = rdarray(acc, no_data=-1.0, geotransform=rd.geotransform,
                  projection=rd.projection, metadata=dict(rd.metadata))
    add_history(out, "FlowAccumFromProps(props)")
    return out


def FlowAccumulation(dem, method="D8", exponent=None, weights=None,
                     in_place=False, seed=0):
    """Upstream flow accumulation for any metric.

    Single-flow metrics (D8/D4/Rho8/Rho4) ride the D8 accumulation sweeps,
    D∞ the two-tap sweeps and the other metrics multi-flow accumulation
    (the topological pass on a card, the sweeps of the reference's TPU
    engines on the CPU)."""
    cite(method)
    rd = _as_rd(dem)
    z = rd.tensor()
    w = None if weights is None else _on(weights, z.device)
    m = method.lower()
    nd_mask = nodata_like(z, rd.no_data)
    if m in ("d8", "d4", "ocallaghan", "rho8", "rho4"):
        if m in ("rho8", "rho4"):
            fd = _flowdirs.rho8_flowdirs(
                z, no_data=rd.no_data, seed=seed,
                topology="D4" if m == "rho4" else "D8", cellsize=rd.cellsize)
        else:
            fd = _flowdirs.d8_flowdirs(z, no_data=rd.no_data,
                                       topology="D4" if m == "d4" else "D8",
                                       cellsize=rd.cellsize)
        acc = _accum.d8_accumulation(fd, weights=w, no_data_mask=nd_mask)
    elif m in ("dinf", "tarboton"):
        ang = _flowdirs.dinf_flowdirs(z, no_data=rd.no_data,
                                      cellsize=rd.cellsize)
        acc = _accum.dinf_accumulation_from_angles(ang, weights=w,
                                                   no_data_mask=nd_mask)
    else:
        props = _flowdirs.flow_proportions(z, method=method,
                                           no_data=rd.no_data,
                                           exponent=exponent,
                                           cellsize=rd.cellsize, seed=seed)
        acc = _accum.flow_accumulation_from_props(props, weights=w,
                                                  no_data_mask=nd_mask)
    acc = torch.where(nd_mask, -1.0, acc)
    call = (f"FlowAccumulation(dem, method={method!r}, "
            f"exponent={exponent!r})")
    if in_place:
        rd.data = acc
        rd.no_data = -1.0
        return add_history(rd, call)
    return _result(rd, acc, call, no_data=-1.0)


# -- terrain -------------------------------------------------------------

def TerrainAttribute(dem, attrib, zscale=1.0):
    """Horn/Zevenbergen-Thorne attribute (see
    :data:`richdem_tpu_torch.ops.terrain.TERRAIN_ATTRIBUTES`)."""
    cite("horn" if attrib.startswith(("slope", "aspect"))
         else "zevenbergen_thorne")
    rd = _as_rd(dem)
    out = _terrain.terrain_attribute(rd.tensor(), attrib, zscale=zscale,
                                     cellsize=rd.cellsize,
                                     no_data=rd.no_data)
    out = torch.where(torch.isnan(out), -9999.0, out)
    res = _result(rd, out,
                  f"TerrainAttribute(dem, attrib={attrib!r}, "
                  f"zscale={zscale!r})")
    res.no_data = -9999.0
    return res


def TWI(accum, slope_radians, cellsize=None):
    """Topographic wetness index from accumulation + slope rasters."""
    cite("twi")
    rd = _as_rd(accum)
    cs = rd.cellsize if cellsize is None else cellsize
    a = rd.tensor()
    out = _methods.twi(a, _on(slope_radians, a.device), cellsize=cs)
    return _result(rd, out, "TWI(accum, slope)")


def SPI(accum, slope_radians, cellsize=None):
    """Stream power index from accumulation + slope rasters."""
    rd = _as_rd(accum)
    cs = rd.cellsize if cellsize is None else cellsize
    a = rd.tensor()
    out = _methods.spi(a, _on(slope_radians, a.device), cellsize=cs)
    return _result(rd, out, "SPI(accum, slope)")


def WatershedLabels(dem_or_flowdirs, from_flowdirs=False):
    """Drainage-basin labels (terminal-cell ids) by the successor
    resolve."""
    rd = _as_rd(dem_or_flowdirs)
    z = rd.tensor()
    fd = z if from_flowdirs else _flowdirs.d8_flowdirs(z,
                                                       no_data=rd.no_data)
    out = _methods.watersheds_from_flowdirs(fd)
    return _result(rd, out, "WatershedLabels(...)")


def UpslopeCells(seeds, flowdirs):
    """Mask of cells draining through any seed cell."""
    rd = _as_rd(flowdirs)
    fd = rd.tensor()
    out = _methods.upslope_cells(_on(seeds, fd.device), fd)
    return _result(rd, out, "UpslopeCells(seeds, flowdirs)")


def StrahlerOrder(flowdirs):
    """Strahler stream order raster from D8 flow directions."""
    rd = _as_rd(flowdirs)
    out = _methods.strahler_order(rd.tensor())
    return _result(rd, out, "StrahlerOrder(flowdirs)")


# -- utilities -----------------------------------------------------------

def rdCompare(a, b, atol=0.0, rtol=0.0, verbose=True):
    """Raster comparison (the reference's ``rd_compare`` app, SURVEY.md
    §2.3): returns True when shapes, nodata layout, and values agree."""
    ra, rb = _as_rd(a), _as_rd(b)
    if ra.shape != rb.shape:
        if verbose:
            print(f"shape mismatch: {ra.shape} vs {rb.shape}")
        return False
    na, nb = ra.np(), rb.np()
    ma, mb = ra.nodata_mask(), rb.nodata_mask()
    if not np.array_equal(ma, mb):
        if verbose:
            print(f"nodata layout differs on {int((ma != mb).sum())} cells")
        return False
    sel = ~ma
    if atol == 0.0 and rtol == 0.0:
        ok = np.array_equal(na[sel], nb[sel])
    else:
        ok = np.allclose(na[sel], nb[sel], atol=atol, rtol=rtol)
    if not ok and verbose:
        diff = np.abs(na[sel].astype(np.float64)
                      - nb[sel].astype(np.float64))
        print(f"values differ: max |Δ| = {diff.max():g} on "
              f"{int((diff > atol).sum())} cells")
    return bool(ok)


def rdShow(rd, ignore_colours=(), show=True, axes=True, cmap="terrain",
           vmin=None, vmax=None, xmin=None, xmax=None, ymin=None, ymax=None,
           zxmin=None, zxmax=None, zymin=None, zymax=None, figsize=(8, 6.5),
           log=False):
    """Matplotlib quicklook (pyrichdem ``rdShow``, whose parameter order
    this keeps, with ``log`` last).  Matplotlib is optional; raises a clear
    error if unavailable.  ``log=True`` draws on a log color scale
    (non-positive cells masked) — the usual view for flow accumulation,
    whose values span ~log(n) decades."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            "rdShow requires matplotlib, which is not installed in this "
            "environment") from e
    rd = _as_rd(rd)
    arr = np.array(rd.np(), dtype=np.float64)
    arr[rd.nodata_mask()] = np.nan
    sub = arr[zymin:zymax, zxmin:zxmax]
    fig, ax = plt.subplots(figsize=figsize)
    if log:
        from matplotlib.colors import LogNorm
        sub = np.where(sub > 0, sub, np.nan)
        img = ax.imshow(sub, cmap=cmap, norm=LogNorm(vmin=vmin, vmax=vmax))
    else:
        img = ax.imshow(sub, cmap=cmap, vmin=vmin, vmax=vmax)
    fig.colorbar(img, ax=ax)
    if not axes:
        ax.axis("off")
    if show:
        plt.show()
    return {"figure": fig, "axes": ax, "vmin": np.nanmin(sub),
            "vmax": np.nanmax(sub)}
