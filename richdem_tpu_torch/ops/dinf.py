"""D∞ accumulation on the packed two-tap field.

Counterpart of ``richdem_tpu.ops.pallas_dinf`` (``dinf_two_tap``,
``pack_two_tap``, ``unpack_two_tap``, ``two_tap_props``,
``_transpose_two_tap``, ``_dinf_gs_impl``, ``dinf_accumulation_gs``) and of
``richdem_tpu.ops.pallas_scan._dinf_scan_impl``, with their TPU kernels
``pallas_dinf._dinf_kernel`` and ``pallas_scan._accum_scan_kernel``.

A D∞ cell splits its flow between two cyclically adjacent D8 directions:
``p`` toward ``code`` and ``1 - p`` toward ``next(code) = code % 8 + 1``.
The pair travels packed in one float32 raster ``v = code + p/2`` (0 =
NO_FLOW), with ``p`` snapped to multiples of 2⁻¹⁷ once, before the
sweeps, so that ``v`` and its transposed field ``(PERM[next(code)], 1 - p)``
are exact and the four sweep orientations see one field.  The sweeps are
the multi-flow sweeps of :mod:`~richdem_tpu_torch.ops.mfd` with the taps
decoded from ``v`` in the kernel (``csrc/dinf_sweep.cu``), at the same
``depth`` choices.  A D8 raster is the two-tap field with ``p = 1``.
"""

from __future__ import annotations

import ctypes

import torch

from richdem_tpu_torch._build import FLOW_TILE, Kernel, stream_handle
from richdem_tpu_torch.debug import span
from richdem_tpu_torch.ops.fill import _require_converged
from richdem_tpu_torch.ops.flowdirs import OCTANT_DIRS, octants_per_radian
from richdem_tpu_torch.ops.mfd import (mfd_sweep_plain, scan_window,
                                       sweep_flags)
from richdem_tpu_torch.ops.stencil import as_tensor
from richdem_tpu_torch.ops.sweeps import (PERM_TRANSPOSE,
                                          accumulation_rotations)

__all__ = ["DINF_SWEEP", "DINF_DEPTH", "P_GRID", "dinf_two_tap",
           "pack_two_tap", "unpack_two_tap", "two_tap_props",
           "transpose_two_tap", "dinf_planes", "dinf_sweep",
           "dinf_sweep_plain", "dinf_accumulation_info",
           "dinf_accumulation"]

_P = ctypes.c_void_p
DINF_SWEEP = Kernel("dinf_sweep", "rd_dinf_sweep",
                    [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P])

#: The in-row scan depth of D∞ accumulation, chosen on an H100 (PERF.md:
#: rotations and time per step at depth 1, 8, 32 and 0).
DINF_DEPTH = 1

#: ``p`` is snapped to multiples of 1/P_GRID before packing, so that
#: ``0.5·p`` (and ``0.5·(1 - p)``) sit exactly beside any code 1..8.
P_GRID = 131072.0  # 2**17


def dinf_two_tap(angles):
    """``(code, p)`` of a D∞ angle raster (int32, float32): the angle's
    octant k gives the directions ``OCTANT[k]`` and ``OCTANT[k + 1]``;
    ``code`` is the latter, ``p`` the fraction toward it.  Angles < 0
    (NO_FLOW, nodata) give ``(0, 0)``."""
    a = angles
    q = a * octants_per_radian(a)
    k = torch.remainder(torch.floor(q).to(torch.int32), 8)
    frac = (q - torch.floor(q)).to(torch.float32)
    octants = torch.tensor(OCTANT_DIRS, dtype=torch.int32, device=a.device)
    flowing = a >= 0.0
    code = torch.where(flowing, octants[((k + 1) % 8).long()],
                       torch.zeros((), dtype=torch.int32, device=a.device))
    p = torch.where(flowing, frac, 0.0)
    return code, p


def pack_two_tap(code, p):
    """One float32 raster ``v = code + p/2`` (0 = NO_FLOW), with ``p``
    snapped to 1/:data:`P_GRID`."""
    p = p.to(torch.float32)
    p_q = torch.clamp(torch.round(p * P_GRID) / P_GRID, 0.0, 1.0)
    return torch.where(code > 0, code.to(torch.float32) + 0.5 * p_q, 0.0)


def unpack_two_tap(v):
    """Inverse of :func:`pack_two_tap` (the snapped ``p`` exactly)."""
    v = v.to(torch.float32)
    fl = torch.floor(v)
    c = fl.to(torch.int32)
    return c, torch.where(c > 0, (v - fl) * 2.0, 0.0)


def two_tap_props(code, p):
    """(H, W, 8) proportions of the two-tap encoding (for oracles)."""
    p = p.to(torch.float32)
    nxt = torch.remainder(code, 8) + 1
    flow = (code > 0).to(torch.float32)
    lo, hi = p * flow, (1.0 - p) * flow
    planes = torch.stack([(code == d).to(torch.float32) * lo
                          + (nxt == d).to(torch.float32) * hi
                          for d in range(1, 9)])
    return planes.permute(1, 2, 0)  # plane-major underneath


def transpose_two_tap(code, p):
    """The two-tap field of the transposed grid, transposed: under the
    reflection the pair's order flips, so ``(code, next)`` with weights
    ``(p, 1 - p)`` becomes ``(PERM[next], PERM[code])`` with ``(1 - p,
    p)``, that is ``code' = PERM[next(code)]`` and ``p' = 1 - p``."""
    flowing = code > 0
    nxt = torch.where(flowing, torch.remainder(code, 8) + 1, 0)
    perm = torch.as_tensor(PERM_TRANSPOSE, device=code.device)
    code_t = perm[nxt.long()].to(code.dtype)
    p_t = torch.where(flowing, 1.0 - p, 0.0)
    return code_t.t().contiguous(), p_t.t().contiguous()


def dinf_planes(v):
    """(8, H, W) tap weights of a packed field, plane d - 1 toward
    direction d, decoded as the kernel decodes each staged row: ``p``
    toward ``code``, ``1 - p`` toward ``next(code)``, 0 elsewhere."""
    fl = torch.floor(v)
    code = fl.to(torch.int32)
    p = (v - fl) * 2.0
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([
        torch.where(code == d, p,
                    torch.where(code == (8 if d == 1 else d - 1), 1.0 - p,
                                zero))
        for d in range(1, 9)])


def dinf_sweep_plain(acc_in, w, v, reverse, depth, tile=FLOW_TILE):
    """Plain version of the D∞ sweep kernel: the multi-flow plain sweep
    over the field's decoded taps, bitwise the kernel's."""
    return mfd_sweep_plain(acc_in, w, dinf_planes(v), reverse, depth, tile)


def dinf_sweep(acc_in, w, v, reverse, depth):
    """One directional D∞ sweep on the packed field (down, or up if
    ``reverse``), out of place.  A CUDA tensor launches
    ``csrc/dinf_sweep.cu`` (raising if it cannot be built or launched); a
    CPU tensor runs the plain version."""
    if not acc_in.is_cuda:
        return dinf_sweep_plain(acc_in, w, v, reverse, depth)
    for x, name in ((acc_in, "acc_in"), (w, "w"), (v, "v")):
        if (x.dim() != 2 or x.dtype != torch.float32
                or not x.is_contiguous() or x.shape != acc_in.shape
                or x.device != acc_in.device):
            raise ValueError(f"{name}: expected a contiguous float32 tensor "
                             f"shaped and placed like acc_in")
    h, wd = acc_in.shape
    out = torch.empty_like(acc_in)
    if h == 0 or wd == 0:
        return out
    flags = sweep_flags(wd, acc_in.device)
    DINF_SWEEP.launch(acc_in.data_ptr(), w.data_ptr(), v.data_ptr(),
                      out.data_ptr(), h, wd, int(bool(reverse)),
                      scan_window(depth), flags.data_ptr(), flags.numel(),
                      stream_handle(acc_in.device))
    return out


def dinf_accumulation_info(code, p, weights, max_rotations=512,
                           depth=DINF_DEPTH, sweep=dinf_sweep):
    """Rotations from ``A = w`` over the two-tap field until a rotation
    changes nothing; returns ``(accum, rotations, converged)`` without
    raising.  ``p`` is snapped once; the transposed field is packed from
    the snapped pair."""
    cq, pq = unpack_two_tap(pack_two_tap(code, p))
    v = pack_two_tap(cq, pq).contiguous()
    v_t = pack_two_tap(*transpose_two_tap(cq, pq)).contiguous()
    w = weights.to(torch.float32).contiguous()
    w_t = w.t().contiguous()
    return accumulation_rotations(
        w, lambda a, rev: sweep(a, w, v, rev, depth),
        lambda a, rev: sweep(a, w_t, v_t, rev, depth), max_rotations)


def dinf_accumulation(code, p, weights=None, no_data_mask=None,
                      max_rotations=512, return_info=False,
                      depth=DINF_DEPTH, device="cuda"):
    """Exact D∞ accumulation from the two-tap encoding (the topological
    queue's result over the snapped proportions); raises if
    ``max_rotations`` rotations do not reach it.  Zero weight and zero
    output at nodata; ``return_info`` adds ``(rotations, converged)``.
    The reference's ``fold_min``/``fold_pad`` shape its TPU layout and have
    no counterpart here.

    ``code``: a tensor (the work runs where it lives) or an array (moved to
    ``device``, as are ``p``, array weights and masks)."""
    with span("rd.dinf"):
        code = as_tensor(code, device)
        p = as_tensor(p, code.device)
        h, wd = code.shape
        if weights is None:
            weights = torch.ones((h, wd), dtype=torch.float32,
                                 device=code.device)
        weights = as_tensor(weights, code.device).to(torch.float32)
        if no_data_mask is not None:
            no_data_mask = as_tensor(no_data_mask, code.device)
            weights = torch.where(no_data_mask, 0.0, weights)
        acc, rotations, done = dinf_accumulation_info(code, p, weights,
                                                      max_rotations, depth)
        _require_converged(done, "D-infinity accumulation", max_rotations)
        if no_data_mask is not None:
            acc = torch.where(no_data_mask, 0.0, acc)
        if return_info:
            return acc, rotations, done
        return acc
