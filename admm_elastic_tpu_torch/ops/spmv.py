"""Banded (DIA) + rest-ELL split of the global matrix for the PCG SpMV.

A copy of ``admm_elastic_tpu/ops/spmv.py:34-180`` (numpy and, for the RCM
permutation, scipy): ``BandPlan``, ``_band_split``, ``_permute_ell``,
``plan_bands`` and ``apply_bands_ref``, bit-equal to the JAX package's.

A's sparsity is a mesh graph: in a locality-preserving vertex order almost
every nonzero sits on one of a few dozen constant diagonals (offsets j - i),
applied as y += band_d * shift(x, d). The thin rest stays in an ELL table;
when the native order is not banded, a reverse-Cuthill-McKee permutation is
taken first, and A x = P^T (A_perm (P x)). Ring lattices take their offsets
modulo N (circular bands), which folds the seam's entries into the main
diagonals.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class BandPlan:
    """Host-side split of an ELL matrix into diagonals + rest.

    offsets: ascending tuple of diagonal offsets (j - i), static.
    bands: [D, N] f64 — bands[d, i] = A[i, i + offsets[d]] (0 if absent).
    rest_cols/rest_vals: [N, Kr] ELL of the leftovers (Kr may be 0).
    perm/iperm: optional [N] i64 vertex permutation (row i of the banded
      matrix is vertex perm[i]); None when the native order was used.
    coverage: fraction of off-diagonal nnz captured by the bands.
    circular: offsets are taken MODULO N (centered) and the apply wraps —
      the exact form for periodic meshes (ring lattices), whose seam
      entries sit at j-i = +-(N - d) and would otherwise fall into the
      rest-ELL gather. Valid for any matrix; chosen when it covers more.
    """

    offsets: Tuple[int, ...]
    bands: np.ndarray
    rest_cols: np.ndarray
    rest_vals: np.ndarray
    perm: Optional[np.ndarray]
    iperm: Optional[np.ndarray]
    coverage: float
    circular: bool = False


def _band_split(ell_cols: np.ndarray, ell_vals: np.ndarray,
                max_bands: int, min_pop: float,
                circular: bool = False) -> BandPlan:
    """Split one ordering's ELL into popular diagonals + rest.

    A diagonal is kept while it holds >= min_pop * N entries (so band
    storage D*N stays within ~1/min_pop of the nnz it captures) and the
    band count stays <= max_bands. With circular=True offsets are taken
    modulo N (centered), merging periodic-seam entries into the main
    diagonals.
    """
    n, k = ell_cols.shape
    live = ell_vals != 0.0
    offs = ell_cols.astype(np.int64) - np.arange(n, dtype=np.int64)[:, None]
    if circular:
        offs = (offs % n + n + n // 2) % n - n // 2
    offs_live = offs[live]
    if offs_live.size == 0:
        return BandPlan((), np.zeros((0, n)), ell_cols[:, :0],
                        ell_vals[:, :0], None, None, 1.0)
    uniq, counts = np.unique(offs_live, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    keep = []
    for idx in order[:max_bands]:
        if counts[idx] < min_pop * n:
            break
        keep.append(int(uniq[idx]))
    keep = tuple(sorted(keep))
    if not keep:
        return BandPlan((), np.zeros((0, n)), ell_cols, ell_vals,
                        None, None, 0.0)
    keep_arr = np.asarray(keep, dtype=np.int64)
    bands = np.zeros((len(keep), n), dtype=np.float64)
    on_band = np.zeros_like(live)
    rr, ss = np.nonzero(live)
    dd = offs[rr, ss]
    pos = np.searchsorted(keep_arr, dd)
    hit = (pos < len(keep)) & (keep_arr[np.minimum(pos, len(keep) - 1)] == dd)
    bands[pos[hit], rr[hit]] = ell_vals[rr[hit], ss[hit]]
    on_band[rr[hit], ss[hit]] = True
    rest_live = live & ~on_band
    kr = int(rest_live.sum(axis=1).max()) if rest_live.any() else 0
    rest_cols = np.zeros((n, kr), dtype=np.int32)
    rest_vals = np.zeros((n, kr), dtype=np.float64)
    if kr:
        slot = np.cumsum(rest_live, axis=1) - 1
        rr, ss = np.nonzero(rest_live)
        rest_cols[rr, slot[rr, ss]] = ell_cols[rr, ss]
        rest_vals[rr, slot[rr, ss]] = ell_vals[rr, ss]
    coverage = float(on_band.sum()) / float(live.sum())
    return BandPlan(keep, bands, rest_cols, rest_vals, None, None, coverage)


def _permute_ell(ell_cols, ell_vals, perm):
    """ELL of P A P^T: row i' = perm-position of old row; same for cols."""
    n = ell_cols.shape[0]
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)
    live = ell_vals != 0.0
    new_cols = np.where(live, iperm[ell_cols.astype(np.int64)], 0)
    return (new_cols[perm].astype(np.int32), ell_vals[perm].copy(), iperm)


def plan_bands(ell_cols: np.ndarray, ell_vals: np.ndarray,
               max_bands: int = 64, min_pop: float = 0.05,
               try_rcm: bool = True,
               coverage_goal: float = 0.9) -> BandPlan:
    """Choose the best banded split: native order, else RCM-permuted.

    Native order wins ties (no permutation gathers). RCM is tried when the
    native coverage misses `coverage_goal` — e.g. meshes whose file order
    scrambles locality.
    """
    native = _band_split(ell_cols, ell_vals, max_bands, min_pop)
    if native.rest_cols.shape[1] > 0:
        # Periodic meshes (ring lattices): seam entries merge into the
        # main diagonals when offsets are taken mod N. The rest drives
        # the apply cost (each rest column is an [N]-row gather where a
        # band is a shifted stream), so prefer the split with fewer rest
        # columns, not just higher coverage.
        circ = dataclasses.replace(
            _band_split(ell_cols, ell_vals, max_bands, min_pop,
                        circular=True),
            circular=True)
        if (circ.rest_cols.shape[1] < native.rest_cols.shape[1]
                and circ.coverage >= native.coverage):
            native = circ
    if native.coverage >= coverage_goal or not try_rcm:
        return native
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except Exception:  # pragma: no cover - scipy is in the image
        return native
    n, k = ell_cols.shape
    live = ell_vals != 0.0
    rows = np.repeat(np.arange(n), k)[live.ravel()]
    cols = ell_cols.ravel()[live.ravel()]
    pat = csr_matrix((np.ones(len(rows), np.int8), (rows, cols)), (n, n))
    perm = np.asarray(reverse_cuthill_mckee(pat, symmetric_mode=True),
                      dtype=np.int64)
    pc, pv, iperm = _permute_ell(ell_cols, ell_vals, perm)
    rcm = _band_split(pc, pv, max_bands, min_pop)
    if rcm.coverage <= native.coverage + 0.05:
        return native
    return dataclasses.replace(rcm, perm=perm, iperm=iperm)


def apply_bands_ref(plan: BandPlan, x: np.ndarray) -> np.ndarray:
    """Numpy oracle of the banded+rest off-diagonal apply (tests)."""
    xp = x if plan.perm is None else x[plan.perm]
    n = xp.shape[0]
    acc = np.zeros_like(xp)
    for d, off in enumerate(plan.offsets):
        if plan.circular:
            acc += plan.bands[d, :, None] * xp[(np.arange(n) + off) % n]
            continue
        lo, hi = max(0, -off), min(n, n - off)
        acc[lo:hi] += plan.bands[d, lo:hi, None] * xp[lo + off:hi + off]
    if plan.rest_cols.shape[1]:
        acc += np.einsum("nk,nkc->nc", plan.rest_vals, xp[plan.rest_cols])
    return acc if plan.perm is None else acc[plan.iperm]
