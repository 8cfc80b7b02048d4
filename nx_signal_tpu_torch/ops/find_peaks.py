"""scipy-style find_peaks with prominences and widths (counterpart of
nx_signal_tpu/ops/find_peaks.py): find_peaks, peak_prominences,
peak_widths, Peaks and find_peaks_cwt.

The results keep the JAX package's fixed shapes: a -1-padded (max_peaks,)
index vector with its valid count, and properties aligned with it.

- Detection: plateau-aware local maxima from the signs of the differences
  and one cummax, elementwise.
- Prominences and widths: range queries answered for every peak at once by
  sparse tables (range max, range min, range argmin with both tie
  orientations; O(n log n) memory) and binary lifting, as in the JAX
  package. A range's level is floor(log2(length)) computed exactly (the JAX
  package takes it from a float32 log2, which rounds up for lengths of
  2^k - 1 from k = 21).
- The properties (thresholds, prominences, the width heights, crossings and
  widths) are computed in f64 over the peaks from the float32 samples, and
  the conditions compare f64 values, as scipy does; the properties are
  returned as float32. The JAX package computes them in float32, where an
  interpolated crossing near sample 8000 keeps three decimals and near
  2^22 rounds to half a sample, so on long signals its width decisions
  part from scipy's.
- The distance filter keeps scipy's greedy set, highest peak first, ties
  to the larger index (the JAX package's stable ascending argsort read
  from its end), positions compared as float32 as there. The JAX package
  loops over all `cap` slots, each step over all of them; here it works on
  the P valid peaks in rounds: each round keeps every undecided peak that
  outranks all undecided peaks within `distance` and drops their
  neighbours, which gives the greedy set. A round is a few passes over P
  (a sparse table of the ranks, one prefix sum), with one sync every
  `_ROUNDS_PER_CHECK` rounds. Peaks still undecided after `_MAX_ROUNDS`
  rounds (a ramp of peaks closer than `distance` needs one round per kept
  peak) are finished by scipy's sequential scan on the host.

`find_peaks_cwt` is the JAX package's host f64 numpy computation: ridge
tracing must not flip on rounding, and an f64 FFT on the card can break
exact ties that numpy keeps.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from nx_signal_tpu_torch.ops.wavelets import _cwt_f64, _host, _ricker_np
from nx_signal_tpu_torch.utils.devices import as_signal
from nx_signal_tpu_torch.utils.dtypes import DEFAULT_FLOAT

__all__ = ["find_peaks", "peak_prominences", "peak_widths", "Peaks", "find_peaks_cwt"]

# Rounds of the distance filter between two checks for undecided peaks (one
# device sync each), and the rounds after which the host scan finishes.
_ROUNDS_PER_CHECK = 8
_MAX_ROUNDS = 256


class Peaks(NamedTuple):
    """indices: (max_peaks,) int32, -1-padded after the first
    `valid_count`; properties: dict of (max_peaks,) tensors aligned with
    indices (padding: 0, or -1 for the int32 ones).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.find_peaks import find_peaks
    >>> pk = find_peaks(torch.tensor([0.0, 2.0, 0.0, 3.0, 0.0]))
    >>> pk.indices, pk.valid_count   # fixed shape, -1 padded
    (tensor([ 1,  3, -1], dtype=torch.int32), tensor(2, dtype=torch.int32))
    """

    indices: torch.Tensor
    valid_count: torch.Tensor
    properties: dict


# ------------------------------------------------------------- detection

def _local_maxima(x):
    """Plateau-aware local maxima (scipy _local_maxima_1d semantics): per
    sample (mask, left edge, right edge), the edges stored at the
    plateau's midpoint."""
    n = x.shape[0]
    s = torch.sign(x[1:] - x[:-1]).to(torch.int64)
    idx = torch.arange(n - 1, device=x.device)
    last_nz = torch.cummax(torch.where(s != 0, idx, -1), dim=0).values
    prev_nz = torch.cat([last_nz.new_full((1,), -1), last_nz[:-1]])
    prev_sign = torch.where(prev_nz >= 0, s[prev_nz.clamp(min=0)], 0)
    is_peak_end = (s == -1) & (prev_sign == 1)
    left_edge = prev_nz + 1
    # the midpoint of each plateau, n (a slot cut off below) elsewhere
    at = torch.where(is_peak_end, (left_edge + idx) // 2, n)
    mask = torch.zeros(n + 1, dtype=torch.bool, device=x.device)
    mask[at] = True
    ledge = torch.zeros(n + 1, dtype=torch.int64, device=x.device)
    ledge[at] = left_edge
    redge = torch.zeros(n + 1, dtype=torch.int64, device=x.device)
    redge[at] = idx
    return mask[:n], ledge[:n], redge[:n]


def _compact(mask, cap):
    """The first `cap` True positions of `mask` in order, -1-padded to
    (cap,) int64."""
    found = torch.nonzero(mask).squeeze(1)[:cap]
    out = torch.full((cap,), -1, dtype=torch.int64, device=mask.device)
    out[:found.shape[0]] = found
    return out


# ------------------------------------------------- sparse range tables

def _levels(n):
    return max(1, int(math.floor(math.log2(max(n, 1)))) + 1)


def _tables(x, reduce, fill):
    """tables[k][i] = reduce(x[i : i + 2^k]), out of range `fill`."""
    tables = [x]
    for k in range(1, _levels(x.shape[0])):
        h = 1 << (k - 1)
        prev = tables[-1]
        tables.append(reduce(prev, torch.cat([prev[h:], prev.new_full((h,), fill)])))
    return tables


def _argmin_tables(x, prefer_larger_index):
    """(values, indices) tables of the range min, ties to the larger
    (left-scan) or the smaller (right-scan) index."""
    vals, idxs = [x], [torch.arange(x.shape[0], device=x.device)]
    for k in range(1, _levels(x.shape[0])):
        h = 1 << (k - 1)
        v, i = vals[-1], idxs[-1]
        v2 = torch.cat([v[h:], v.new_full((h,), math.inf)])
        i2 = torch.cat([i[h:], i.new_full((h,), -1)])
        take_right = v2 <= v if prefer_larger_index else v2 < v
        vals.append(torch.where(take_right, v2, v))
        idxs.append(torch.where(take_right, i2, i))
    return vals, idxs


def _gather(table, i):
    return table[i.clamp(0, table.shape[0] - 1)]


def _search_left(tables, p, lo, v, skip_below):
    """The window start e in [lo, p] such that x[e-1] breaks the skip
    predicate (or e == lo): skip_below=True skips blocks whose max <= v
    (the previous strictly greater sample), False blocks whose min > v
    (the previous sample <= v; `tables` then hold minima)."""
    e = p
    for k in reversed(range(len(tables))):
        start = e - (1 << k)
        stat = _gather(tables[k], start)
        skip = stat <= v if skip_below else stat > v
        e = torch.where((start >= lo) & skip, start, e)
    return e


def _search_right(tables, p, hi, v, skip_below):
    """Mirror of _search_left over [p+1, hi]: e in [p+1, hi+1] with x[e]
    breaking the skip predicate (or e == hi+1)."""
    e = p + 1
    for k in reversed(range(len(tables))):
        blk = 1 << k
        stat = _gather(tables[k], e)
        skip = stat <= v if skip_below else stat > v
        e = torch.where((e + blk <= hi + 1) & skip, e + blk, e)
    return e


def _floor_log2(length):
    """floor(log2(length)) of positive int64 lengths, exact."""
    return torch.floor(torch.log2(length.clamp(min=1).to(torch.float64))).to(torch.int64)


def _range_argmin(vals, idxs, lo, hi, prefer_larger):
    """(min value, tie-resolved index) over inclusive [lo, hi] (lo <= hi)
    for every query: two overlapping blocks of the query's level. The tie
    orientation must be the one the tables were built with."""
    klev = _floor_log2(hi - lo + 1)
    out_v, out_i = _gather(vals[0], lo), _gather(idxs[0], lo)
    for k in range(len(vals)):
        blk = 1 << k
        v1, i1 = _gather(vals[k], lo), _gather(idxs[k], lo)
        v2, i2 = _gather(vals[k], hi - blk + 1), _gather(idxs[k], hi - blk + 1)
        tie = (v2 == v1) & ((i2 > i1) if prefer_larger else (i2 < i1))
        take2 = (v2 < v1) | tie
        sel = klev == k
        out_v = torch.where(sel, torch.where(take2, v2, v1), out_v)
        out_i = torch.where(sel, torch.where(take2, i2, i1), out_i)
    return out_v, out_i


# ------------------------------------------------------------ prominences

def _wlen_half(wlen):
    if wlen is None:
        return None
    wlen = int(wlen)
    if wlen < 2:
        raise ValueError(f"wlen must be at least 2, got {wlen}")
    if wlen % 2 == 0:
        wlen += 1  # scipy rounds an even wlen up to the next odd
    return (wlen - 1) // 2


def _prominence_arrays(x, peaks, valid, wlen=None):
    n = x.shape[0]
    v = _gather(x, peaks)
    half = _wlen_half(wlen)
    lo = torch.zeros_like(peaks) if half is None else (peaks - half).clamp(min=0)
    hi = torch.full_like(peaks, n - 1) if half is None else (peaks + half).clamp(max=n - 1)
    maxt = _tables(x, torch.maximum, -math.inf)
    lvals, lidx = _argmin_tables(x, prefer_larger_index=True)
    rvals, ridx = _argmin_tables(x, prefer_larger_index=False)

    e_l = _search_left(maxt, peaks, lo, v, skip_below=True)
    lmin, lbase = _range_argmin(lvals, lidx, e_l, peaks, prefer_larger=True)
    e_r = _search_right(maxt, peaks, hi, v, skip_below=True)
    rmin, rbase = _range_argmin(rvals, ridx, peaks, e_r - 1, prefer_larger=False)

    prom = v.double() - torch.maximum(lmin, rmin).double()
    return (torch.where(valid, prom, 0.0), torch.where(valid, lbase, -1),
            torch.where(valid, rbase, -1))


def _signal_and_peaks(x, peaks):
    """x as a float32 1-D signal (`as_signal`) and the peaks (-1 padding
    allowed) as int64 on its device."""
    x = as_signal(x).to(DEFAULT_FLOAT)
    if x.ndim != 1:
        raise ValueError("x must be 1-D")
    peaks = torch.as_tensor(peaks, device=x.device).to(torch.int64)
    return x, peaks


def peak_prominences(x, peaks, *, wlen=None):
    """Prominence of each peak and its left/right bases,
    scipy.signal.peak_prominences semantics (the base on each side is the
    minimum between the peak and the nearest strictly higher sample, or the
    signal's or wlen window's edge, ties toward the peak). `peaks` may be
    -1-padded (find_peaks' encoding): padded rows get prominence 0 and
    bases -1. Returns (prominences float32, left_bases, right_bases int32).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.find_peaks import peak_prominences
    >>> prom, lb, rb = peak_prominences(torch.tensor([0.0, 2.0, 0.0, 3.0, 0.0]), [1, 3])
    >>> prom, lb, rb
    (tensor([2., 3.]), tensor([0, 2], dtype=torch.int32), tensor([2, 4], dtype=torch.int32))
    """
    x, peaks = _signal_and_peaks(x, peaks)
    prom, lbase, rbase = _prominence_arrays(x, peaks.clamp(min=0), peaks >= 0, wlen)
    return prom.to(DEFAULT_FLOAT), lbase.to(torch.int32), rbase.to(torch.int32)


# ------------------------------------------------------------------ widths

def _width_arrays(x, peaks, valid, rel_height, prom, lbase, rbase):
    v = _gather(x, peaks).double()
    height = v - prom * rel_height
    mint = _tables(x, torch.minimum, math.inf)
    lbase, rbase = lbase.clamp(min=0), rbase.clamp(min=0)

    # left crossing: the largest i in [lbase, p] with x[i] <= height
    e_l = _search_left(mint, peaks, lbase, height, skip_below=False)
    i_l = torch.maximum(e_l - 1, lbase)
    xl, xl1 = _gather(x, i_l).double(), _gather(x, i_l + 1).double()
    frac_l = torch.where(xl < height,
                         (height - xl) / torch.where(xl1 == xl, 1.0, xl1 - xl), 0.0)
    left_ip = i_l.to(height.dtype) + frac_l

    # right crossing: the smallest i in [p, rbase] with x[i] <= height
    e_r = _search_right(mint, peaks, rbase, height, skip_below=False)
    i_r = torch.minimum(e_r, rbase)
    xr, xr1 = _gather(x, i_r).double(), _gather(x, i_r - 1).double()
    frac_r = torch.where(xr < height,
                         (height - xr) / torch.where(xr1 == xr, 1.0, xr1 - xr), 0.0)
    right_ip = i_r.to(height.dtype) - frac_r

    return tuple(torch.where(valid, a, 0.0)
                 for a in (right_ip - left_ip, height, left_ip, right_ip))


def peak_widths(x, peaks, *, rel_height=0.5, wlen=None):
    """Width of each peak at `rel_height` of its prominence,
    scipy.signal.peak_widths semantics (linearly interpolated crossings of
    peak height - prominence * rel_height, bounded by the prominence bases).
    Returns (widths, width_heights, left_ips, right_ips), float32 (computed
    in f64, module docstring); -1-padded peaks give zero rows.

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.find_peaks import peak_widths
    >>> widths, heights, lips, rips = peak_widths(torch.tensor([0.0, 1.0, 2.0, 1.0, 0.0]), [2])
    >>> widths, heights
    (tensor([2.]), tensor([1.]))
    """
    if rel_height < 0:
        raise ValueError("rel_height must be greater or equal to 0")
    x, peaks = _signal_and_peaks(x, peaks)
    valid = peaks >= 0
    p = peaks.clamp(min=0)
    prom, lbase, rbase = _prominence_arrays(x, p, valid, wlen)
    return tuple(a.to(DEFAULT_FLOAT)
                 for a in _width_arrays(x, p, valid, rel_height, prom, lbase, rbase))


# ---------------------------------------------------------------- filters

def _unpack_interval(value, peaks, x_len, name, device):
    """scipy's _unpack_condition_args: a number, an array of x's length
    (taken at the peaks), or a (min, max) pair with None for an open end;
    floating-point bounds as f64."""
    def at_peaks(v):
        if v is None:
            return None
        v = torch.as_tensor(v, device=device)
        if v.dtype.is_floating_point:
            v = v.double()
        if v.ndim == 0:
            return v
        if v.shape[0] != x_len:
            raise ValueError(f"array {name} must have the same length as x")
        return _gather(v, peaks)

    if isinstance(value, (tuple, list)):
        if len(value) != 2:
            raise ValueError(f"{name} must be a number, array, or (min, max)")
        return at_peaks(value[0]), at_peaks(value[1])
    return at_peaks(value), None


def _range_max_tables(r):
    """Sparse table of range maxima of the int64 ranks `r`, stacked
    (levels, P)."""
    return torch.stack(_tables(r, torch.maximum, -1))


def _distance_filter(positions, heights, valid, distance, cap):
    """scipy's greedy suppression over the valid peaks (module docstring):
    highest first, ties to the larger slot; a kept peak removes every other
    peak closer than `distance`. Returns the kept mask over the cap slots."""
    slots = torch.nonzero(valid).squeeze(1)
    keep = torch.zeros_like(valid)
    count = slots.shape[0]
    if count == 0:
        return keep
    # positions as float32, as the JAX package compares them (exact below
    # 2^24), back to integers; a gap g is "closer" iff g < float32(distance)
    pos = positions[slots].to(torch.float32).to(torch.int64)
    reach = math.ceil(float(np.float32(distance))) - 1
    lo = torch.searchsorted(pos, pos - reach, side="left")
    hi = torch.searchsorted(pos, pos + reach, side="right") - 1
    order = torch.sort(heights[slots], stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(count, device=order.device)

    klev = _floor_log2(hi - lo + 1)
    undecided = torch.ones(count, dtype=torch.bool, device=valid.device)
    kept = torch.zeros_like(undecided)
    rounds = 0
    while True:
        for _ in range(_ROUNDS_PER_CHECK):
            r = torch.where(undecided, rank, -1)
            table = _range_max_tables(r)
            top = torch.maximum(table[klev, lo], table[klev, hi - (1 << klev) + 1])
            won = undecided & (r == top)
            ends = torch.cat([won.new_zeros(1, dtype=torch.int64), torch.cumsum(won, 0)])
            kept |= won
            undecided &= ends[hi + 1] == ends[lo]
        rounds += _ROUNDS_PER_CHECK
        if not bool(undecided.any()):
            break
        if rounds >= _MAX_ROUNDS:
            kept |= _scan_host(undecided, rank, lo, hi)
            break
    keep[slots] = kept
    return keep


def _scan_host(undecided, rank, lo, hi):
    """scipy's sequential greedy scan over the undecided peaks on the host
    (no kept peak lies within reach of them): highest rank first, each kept
    peak clears its window."""
    alive = undecided.cpu().numpy().copy()
    rank_h, lo_h, hi_h = rank.cpu().numpy(), lo.cpu().numpy(), hi.cpu().numpy()
    kept = np.zeros_like(alive)
    candidates = np.nonzero(alive)[0]
    for i in candidates[np.argsort(rank_h[candidates])[::-1]]:
        if alive[i]:
            kept[i] = True
            alive[lo_h[i]:hi_h[i] + 1] = False
    return torch.as_tensor(kept, device=undecided.device)


def find_peaks(x, *, height=None, threshold=None, distance=None, prominence=None,
               width=None, wlen=None, rel_height=0.5, plateau_size=None, max_peaks=None):
    """Local maxima subject to property conditions, scipy.signal.find_peaks
    semantics (the same condition order: plateau_size, height, threshold,
    distance, prominence, width; each a number, an array of x's length, or a
    (min, max) pair with None for an open end). `x` goes through
    `utils.devices.as_signal` and is computed in float32.

    Returns `Peaks(indices, valid_count, properties)` with fixed shapes:
    indices is (max_peaks,) -1-padded (default capacity (n+1)//2, the most
    there can be; with a smaller capacity the left-most peaks are kept).

    Examples:

    >>> import torch
    >>> from nx_signal_tpu_torch.ops.find_peaks import find_peaks
    >>> p = find_peaks(torch.tensor([0.0, 2.0, 0.0, 3.0, 0.0, 1.0, 0.0]), height=1.5)
    >>> p.indices
    tensor([ 1,  3, -1, -1], dtype=torch.int32)
    >>> p.valid_count
    tensor(2, dtype=torch.int32)
    >>> p.properties["peak_heights"]
    tensor([2., 3., 0., 0.])
    """
    x = as_signal(x).to(DEFAULT_FLOAT)
    if x.ndim != 1:
        raise ValueError("x must be 1-D")
    n = x.shape[0]
    cap = (n + 1) // 2 if max_peaks is None else int(max_peaks)
    if cap < 1:
        raise ValueError("max_peaks must be positive")
    if distance is not None and distance < 1:
        raise ValueError("distance must be greater or equal to 1")
    dev = x.device

    mask, ledges, redges = _local_maxima(x)
    peaks = _compact(mask, cap)
    valid = peaks >= 0
    p = peaks.clamp(min=0)
    props = {}

    if plateau_size is not None:
        le, re = _gather(ledges, p), _gather(redges, p)
        sizes = re - le + 1
        pmin, pmax = _unpack_interval(plateau_size, p, n, "plateau_size", dev)
        if pmin is not None:
            valid &= sizes >= pmin
        if pmax is not None:
            valid &= sizes <= pmax
        props["plateau_sizes"] = torch.where(valid, sizes, 0)
        props["left_edges"] = torch.where(valid, le, -1)
        props["right_edges"] = torch.where(valid, re, -1)

    heights_at = _gather(x, p)
    if height is not None:
        hmin, hmax = _unpack_interval(height, p, n, "height", dev)
        if hmin is not None:
            valid &= heights_at.double() >= hmin
        if hmax is not None:
            valid &= heights_at.double() <= hmax
        props["peak_heights"] = torch.where(valid, heights_at, 0.0)

    if threshold is not None:
        tmin, tmax = _unpack_interval(threshold, p, n, "threshold", dev)
        left_t = heights_at.double() - _gather(x, (p - 1).clamp(min=0)).double()
        right_t = heights_at.double() - _gather(x, (p + 1).clamp(max=n - 1)).double()
        if tmin is not None:
            valid &= torch.minimum(left_t, right_t) > tmin
        if tmax is not None:
            valid &= torch.maximum(left_t, right_t) < tmax
        props["left_thresholds"] = torch.where(valid, left_t, 0.0)
        props["right_thresholds"] = torch.where(valid, right_t, 0.0)

    if distance is not None:
        valid = _distance_filter(p, heights_at, valid, float(distance), cap)

    if prominence is not None or width is not None:
        prom, lbase, rbase = _prominence_arrays(x, p, valid, wlen)
        if prominence is not None:
            pmin, pmax = _unpack_interval(prominence, p, n, "prominence", dev)
            if pmin is not None:
                valid &= prom >= pmin
            if pmax is not None:
                valid &= prom <= pmax
        props["prominences"] = torch.where(valid, prom, 0.0)
        props["left_bases"] = torch.where(valid, lbase, -1)
        props["right_bases"] = torch.where(valid, rbase, -1)

    if width is not None:
        widths, wh, lip, rip = _width_arrays(x, p, valid, rel_height, props["prominences"],
                                             props["left_bases"], props["right_bases"])
        wmin, wmax = _unpack_interval(width, p, n, "width", dev)
        if wmin is not None:
            valid &= widths >= wmin
        if wmax is not None:
            valid &= widths <= wmax
        props["widths"] = torch.where(valid, widths, 0.0)
        props["width_heights"] = torch.where(valid, wh, 0.0)
        props["left_ips"] = torch.where(valid, lip, 0.0)
        props["right_ips"] = torch.where(valid, rip, 0.0)

    # the surviving peaks front-packed, the properties aligned; the integer
    # ones are int32 and padded with -1, as in the JAX package
    survivors = torch.nonzero(valid).squeeze(1)
    count = survivors.shape[0]

    def packed(a, integer):
        out = torch.full((cap,), -1 if integer else 0, device=dev,
                         dtype=torch.int32 if integer else DEFAULT_FLOAT)
        out[:count] = a[survivors]
        return out

    return Peaks(indices=packed(peaks, True),
                 valid_count=torch.tensor(count, dtype=torch.int32, device=dev),
                 properties={k: packed(a, not a.dtype.is_floating_point)
                             for k, a in props.items()})


# ------------------------------------------------------- find_peaks_cwt

def _row_relmax(matr):
    """Strict interior local maxima per row, order 1, edges clamped
    (boundary samples never qualify); scipy _boolrelextrema(axis=1,
    order=1) semantics."""
    out = np.zeros(matr.shape, dtype=bool)
    out[:, 1:-1] = (matr[:, 1:-1] > matr[:, :-2]) & (matr[:, 1:-1] > matr[:, 2:])
    return out


def _identify_ridge_lines(matr, max_distances, gap_thresh):
    """Connect per-row local maxima into ridge lines down the scale axis
    (Du et al. 2006, scipy.signal semantics): start at the largest width
    with any maxima; toward smaller widths each maximum claims the nearest
    live line whose tail column (as of the row's entry) is within
    max_distances[row], else it starts a new line; a line idle for more
    than gap_thresh rows is closed. Returns [rows, cols] pairs per line in
    ascending-row order."""
    relmax = _row_relmax(matr)
    rows_with_max = np.nonzero(relmax.any(axis=1))[0]
    if rows_with_max.size == 0:
        return []
    top = int(rows_with_max[-1])

    seed_cols = np.nonzero(relmax[top])[0]
    trace = [[(top, int(c))] for c in seed_cols]  # per-line (row, col) trail
    tail = seed_cols.astype(np.int64)  # the column each line last claimed
    idle = np.zeros(tail.size, dtype=np.int64)  # rows since that claim
    closed = []

    for row in range(top - 1, -1, -1):
        idle += 1
        cand = np.nonzero(relmax[row])[0]
        if tail.size and cand.size:
            # the row's claims against the tails as they stood at its entry
            dist = np.abs(cand[:, None] - tail[None, :])
            owner = dist.argmin(axis=1)
            claimed = dist[np.arange(cand.size), owner] <= max_distances[row]
        else:
            owner = np.zeros(cand.size, dtype=np.intp)
            claimed = np.zeros(cand.size, dtype=bool)

        for c, o, ok in zip(cand, owner, claimed):
            if ok:
                trace[o].append((row, int(c)))
                idle[o] = 0
                tail[o] = c  # seen from the next row on
            else:
                trace.append([(row, int(c))])
        born = cand[~claimed]
        if born.size:
            tail = np.concatenate([tail, born.astype(np.int64)])
            idle = np.concatenate([idle, np.zeros(born.size, np.int64)])

        expired = idle > gap_thresh
        if expired.any():
            closed.extend(trace[i] for i in np.nonzero(expired)[0])
            trace = [t for t, dead in zip(trace, expired) if not dead]
            tail, idle = tail[~expired], idle[~expired]

    out_lines = []
    for t in closed + trace:
        r = np.asarray([q[0] for q in t])
        c = np.asarray([q[1] for q in t])
        # point i goes to its ascending-row rank (a scatter, as scipy's
        # output shows when a line claimed two maxima of one row)
        dst = np.argsort(r)
        rows_out = np.empty(r.size, dtype=r.dtype)
        cols_out = np.empty(c.size, dtype=c.dtype)
        rows_out[dst] = r
        cols_out[dst] = c
        out_lines.append([rows_out, cols_out])
    return out_lines


def _filter_ridge_lines(cwt_mat, ridge_lines, window_size, min_length, min_snr, noise_perc):
    """Keep the ridge lines of at least min_length rows whose smallest-scale
    SNR is at least min_snr, the noise floor the noise_perc'th percentile of
    the raw smallest-scale coefficients over a window_size neighbourhood
    (scipy _filter_ridge_lines semantics)."""
    n_points = cwt_mat.shape[1]
    if min_length is None:
        min_length = math.ceil(cwt_mat.shape[0] / 4.0)
    if window_size is None:
        window_size = math.ceil(n_points / 20.0)
    hf_window, odd = divmod(int(window_size), 2)
    row_one = cwt_mat[0, :]
    noises = np.array([
        np.percentile(row_one[max(ind - hf_window, 0):min(ind + hf_window + odd, n_points)],
                      noise_perc)
        for ind in range(n_points)])

    def keep(line):
        if len(line[0]) < min_length:
            return False
        with np.errstate(divide="ignore"):
            snr = abs(cwt_mat[line[0][0], line[1][0]] / noises[line[1][0]])
        return snr >= min_snr

    return [line for line in ridge_lines if keep(line)]


def find_peaks_cwt(vector, widths, wavelet=None, max_distances=None, gap_thresh=None,
                   min_length=None, min_snr: float = 1, noise_perc: float = 10,
                   window_size=None):
    """Wavelet-based peak finding, scipy.signal.find_peaks_cwt semantics:
    the continuous wavelet transform over `widths` (default wavelet:
    ricker), ridge lines traced across scales, and the ridges long and loud
    enough kept; returns the sorted column indices (numpy int64) where the
    surviving ridges reach the smallest scale.

    Runs on the host in f64 numpy, as the JAX package does (ridge tracing is
    sequential bookkeeping over comparisons that must not flip on
    rounding); a tensor `vector`, on the card too, is copied to the host.
    Use `cwt` for the transform on the card.

    Examples:

    Peaks of a period-20 float32 sine found by wavelet ridge lines (as
    scipy finds them in f64 from the same float32 samples):

    >>> import numpy as np, torch
    >>> from nx_signal_tpu_torch.ops.find_peaks import find_peaks_cwt
    >>> x = torch.sin(2 * torch.pi * torch.arange(100) / 20.0)
    >>> find_peaks_cwt(x, np.arange(3, 10))
    array([ 6, 25, 45, 65, 86])
    """
    widths = np.atleast_1d(np.asarray(_host(widths), dtype=np.float64))
    if widths.size == 0:
        raise ValueError("widths must be nonempty")
    if gap_thresh is None:
        gap_thresh = np.ceil(widths[0])
    if max_distances is None:
        max_distances = widths / 4.0
    max_distances = np.atleast_1d(np.asarray(_host(max_distances)))
    if max_distances.shape[0] < widths.shape[0]:
        raise ValueError("max_distances must have at least as many entries as widths")
    if wavelet is None:
        wavelet = _ricker_np
    cwt_mat = _cwt_f64(vector, wavelet, widths)
    ridge_lines = _identify_ridge_lines(cwt_mat, max_distances, gap_thresh)
    filtered = _filter_ridge_lines(cwt_mat, ridge_lines, window_size, min_length, min_snr,
                                   noise_perc)
    return np.asarray(sorted(line[1][0] for line in filtered), dtype=np.int64)
