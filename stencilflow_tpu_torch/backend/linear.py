"""Linear-stencil extraction and the banded-transform plan of a stage.

Copied from ``stencilflow_tpu/backend/linear.py``, cut to what the port
uses, with no change of meaning.  A stage whose expression is an affine
combination of field accesses,

    out[x] = bias + sum_f sum_o  c_{f,o} * f[x + o],

is computed per (j, k)-plane as banded transforms instead of a
per-access sum: the coefficients are grouped by i-offset into small
(2rj+1)x(2rk+1) matrices ``C``, each factored as ``C = sum_m u_m v_m^T``
(SVD of a tiny matrix, at compile time), and each rank term applied as

    term_m = L(u_m) @ P @ R(v_m),   L[j, j+oj] = u_m[oj], R[k+ok, k] = v_m[ok]

with band truncation at the matrix edges implementing zero boundaries
exactly and a static correction plane lifting them to any constant BC.
The stream kernel (stream.py) executes the plans.

Left out of the copy: the blocked-banded layout (``_blocked_rows``, which
feeds 128-wide MXU blocks): the port's kernel tiles (j, k) itself and
reads global coordinates, so on one device one global band per side is
exact.  The origin-stacked matrices (the ``j_contexts``/``k_contexts``
branch) serve the sharded stream kernel: one slice per shard instance
of the halo-widened shard plane (``parallel/domain.py``
``_sharded_mxu_assets``).  The TPU's bf16 hi/lo operand split becomes a TF32 hi/lo split
on the H100's tensor cores for wide bands under ``mxu_precision="split"``
(see stream.py); the matrices stay f32.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import ir
from ..config import JUNK_VAL
from .stacked_io import round_bf16

Offset2 = Tuple[int, int]


class NotLinear(Exception):
    pass


def _combine(a: Dict, b: Dict, sign: float) -> Dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + sign * v
    return out


def _scale(a: Dict, s: float) -> Dict:
    return {k: v * s for k, v in a.items()}


def _linear_expr(expr: ir.Expr, env: Dict[str, Dict]) -> Dict:
    """Coefficient map {('const',): bias, (field, offsets): coeff}."""
    if isinstance(expr, ir.Const):
        return {("const",): float(expr.value)}
    if isinstance(expr, ir.Ref):
        if expr.name not in env:
            raise NotLinear("unknown temporary")
        return env[expr.name]
    if isinstance(expr, ir.Access):
        return {(expr.field, expr.offsets): 1.0}
    if isinstance(expr, ir.UnaryOp):
        return _scale(_linear_expr(expr.operand, env), -1.0)
    if isinstance(expr, ir.BinOp):
        if expr.op == "add":
            return _combine(_linear_expr(expr.left, env),
                            _linear_expr(expr.right, env), 1.0)
        if expr.op == "sub":
            return _combine(_linear_expr(expr.left, env),
                            _linear_expr(expr.right, env), -1.0)
        if expr.op in ("mult", "div"):
            left = _linear_expr(expr.left, env)
            right = _linear_expr(expr.right, env)
            lconst = set(left) <= {("const",)}
            rconst = set(right) <= {("const",)}
            if expr.op == "mult":
                if lconst:
                    return _scale(right, left.get(("const",), 0.0))
                if rconst:
                    return _scale(left, right.get(("const",), 0.0))
                raise NotLinear("product of two field terms")
            if rconst:
                d = right.get(("const",), 0.0)
                if d == 0.0:
                    raise NotLinear("division by zero constant")
                return _scale(left, 1.0 / d)
            raise NotLinear("division by a field term")
    raise NotLinear(f"non-affine node {type(expr).__name__}")


@dataclasses.dataclass
class BandTerm:
    """One rank term of one i-offset group: L @ P @ R (either side may be
    identity, signaled by a None matrix key)."""
    left_key: Optional[str]     # key into the shared matrix pool (J x J)
    right_key: Optional[str]    # (K x K)
    scale: float                # scalar factor applied to EVERY term (for
    #                             one-sided terms it carries _normalize's
    #                             magnitude)


@dataclasses.dataclass
class PlaneGroup:
    """All contributions of one field at one i-offset."""
    field: str
    oi: Optional[int]
    terms: List[BandTerm]
    weight_sum: float            # sum of coefficients (i-OOB constant value)
    bc_value: float              # constant BC value (JUNK for shrink)
    correction_key: Optional[str]  # static j/k constant-BC correction plane


@dataclasses.dataclass
class LinearStagePlan:
    groups: List[PlaneGroup]
    bias: float
    footprint: int                  # total weighted accesses (for gating)


def extract_linear(kspec: ir.KernelSpec) -> Optional[Dict]:
    """Affine coefficient map of a kernel, or None if not affine."""
    env: Dict[str, Dict] = {}
    try:
        for stmt in kspec.statements:
            env[stmt.lhs] = _linear_expr(stmt.rhs, env)
    except NotLinear:
        return None
    return env[kspec.output_statement.lhs]


class MatrixPool:
    """Deduplicated static matrices / planes the kernel reads."""

    def __init__(self):
        self.items: Dict[str, np.ndarray] = {}

    def add(self, arr: np.ndarray, prefix: str) -> str:
        # content digest, not Python's salted hash(): keys are
        # deterministic across processes and equal to the JAX package's
        digest = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
        key = f"{prefix}_{digest}_{'x'.join(map(str, arr.shape))}"
        self.items.setdefault(key, arr)
        return key


def _ringed(program: ir.Program, field: str) -> bool:
    return field in program.kernels or (
        field in program.inputs and program.inputs[field].dim_mask[0])


def finalize_pool(plans: Dict[str, object], pool: MatrixPool, program,
                  mxu_precision: str = "split"):
    """(pool_keys, pool_arrays, transform_keys) for a set of stage plans:
    prune the pool to referenced matrices, order deterministically, and
    collect the (field, L, R) transform-ring keys of i-streamed fields.

    ``"split"`` and ``"exact"`` keep every matrix in f32: the port's
    kernel splits operands itself (TF32 hi/lo on tensor cores for wide
    bands under "split"), so there are no ``__lo`` residual matrices.
    The opt-in single-pass ``"bf16"`` mode rounds the band matrices (the
    ``L``/``R`` keys) to bf16 with no residual, as the JAX package's
    does; correction planes and composed i-tables stay f32, and the
    kernel rounds each pass's operand plane (the plan's
    ``mxu_precision`` records the mode, where the JAX package keeps its
    ``__precision__`` sentinel)."""
    if mxu_precision not in ("split", "bf16", "exact"):
        raise ValueError(f"unknown mxu_precision {mxu_precision!r} "
                         "(expected split, bf16, or exact)")
    used = set()
    tkeys = set()
    for mp in plans.values():
        if not hasattr(mp, "groups"):     # ComposedPlan (compose.py)
            used.update(k for k in (mp.lkey, mp.rkey, mp.table_key) if k)
            if (mp.lkey or mp.rkey) and _ringed(program, mp.field):
                tkeys.add((mp.field, mp.lkey, mp.rkey))
            continue
        for grp in mp.groups:
            if grp.correction_key:
                used.add(grp.correction_key)
            for t in grp.terms:
                used.update(k for k in (t.left_key, t.right_key) if k)
                if (t.left_key or t.right_key) and _ringed(program,
                                                           grp.field):
                    tkeys.add((grp.field, t.left_key, t.right_key))
    pkeys = sorted(used)
    parrs = [pool.items[k] for k in pkeys]
    if mxu_precision == "bf16":
        parrs = [round_bf16(torch.from_numpy(np.asarray(a, np.float32)))
                 .numpy() if k.startswith(("L", "R")) else a
                 for k, a in zip(pkeys, parrs)]
    tkeys = sorted(tkeys, key=lambda t: (t[0], t[1] or "", t[2] or ""))
    return pkeys, parrs, tkeys


def stacked_axes(key: str) -> Tuple[int, ...]:
    """The shard-instance axes (0 = j, 1 = k) a pool entry is stacked
    over, its leading dim: L matrices over the j instances, R over the k
    ones, correction planes over their j-major cross product; () for an
    entry every instance shares."""
    if key.startswith("Ls_"):
        return (0,)
    if key.startswith("Rs_"):
        return (1,)
    if key.startswith("corrs_"):
        return (0, 1)
    return ()


def is_stacked_key(key: str) -> bool:
    """True for pool entries holding one slice per tile/shard instance
    (leading dim selected per shard)."""
    return bool(stacked_axes(key))


def banded_types(program, kspec) -> bool:
    """May a stage be banded by its types: float32 alone?  The transforms
    compute in f32 and round once at the store, which would silently
    degrade f64 programs, cannot give integer wraparound, and drifts from
    the per-op rounding of bf16 and f16 (box3d r2 typed bf16 at 16^3,
    seed 3: the JAX package's stream kernel lands 0.07955 relative from
    the oracle, far past MXU_VERIFY_RTOL, as
    tests/test_torch_narrow.py::test_k3b_keeps_narrow_stages_per_cell
    measures; the port keeps such stages per cell)."""
    return all(np.dtype(t) == np.float32 for t in
               [kspec.dtype] + [program.field_dtype(f)
                                for f in kspec.accesses()])


def plan_all_stages(program, plane, dims, pool: MatrixPool,
                    min_footprint: int, j_contexts=None, k_contexts=None,
                    exclude=()) -> Dict[str, LinearStagePlan]:
    """Banded plans for every eligible stage of a program (the contexts
    as ``plan_linear_stage`` takes them).

    Stages touching any type but f32 stay on the per-cell path
    (``banded_types``)."""
    plans: Dict[str, LinearStagePlan] = {}
    for kname, kspec in program.kernels.items():
        if kname in exclude:
            # composed segments get their exact plan from plan_composed;
            # their interior-only IR must never be SVD-planned
            continue
        if not banded_types(program, kspec):
            continue
        mp = plan_linear_stage(kspec, plane, dims, pool,
                               min_footprint=min_footprint,
                               j_contexts=j_contexts,
                               k_contexts=k_contexts)
        if mp is not None:
            plans[kname] = mp
    return plans


def mxu_flops_per_cell(pool: Dict[str, np.ndarray], transform_keys
                       ) -> float:
    """Executed f32 flops per domain cell of the plan's band transforms.

    Each unique ``(field, L, R)`` transform is computed once per source
    plane (in a transform ring, or at its reader's step).  A side counts
    2 flops (one FMA) per diagonal per plane cell: the band's own work,
    whatever route the kernel takes (tensor-core passes multiply padded
    16 x 8 fragments three times over).  The JAX package counts MXU
    passes over 128-lane contraction chunks here instead."""
    total = 0.0
    for _field, lkey, rkey in transform_keys:
        for key, side in ((lkey, "L"), (rkey, "R")):
            if key is not None:
                total += 2.0 * len(band_diagonals(pool[key], side)[0])
    return total


def mxu_bf16_flops_per_cell(pool: Dict[str, np.ndarray], transform_keys
                            ) -> float:
    """Executed tensor-core flops per domain cell of the plan's band
    transforms as single-pass bf16 passes (``mxu_precision="bf16"``): a
    side's 16 x 8 output tile takes one m16n8k16 product per k-step of
    16, ``ceil((taps + 7) / 16)`` steps (the fragments' depth padding
    included), 2 x 16 flops a cell per step."""
    total = 0.0
    for _field, lkey, rkey in transform_keys:
        for key, side in ((lkey, "L"), (rkey, "R")):
            if key is not None:
                taps = len(band_diagonals(pool[key], side)[0])
                total += 2.0 * 16 * -(-(taps + 7) // 16)
    return total


def band_diagonals(matrix: np.ndarray, side: str,
                   span: Optional[Tuple[int, int]] = None):
    """Diagonal form of a pooled band matrix, as the kernel applies it:
    ``out[p] = sum_d coef[d - d0, p] * in[p + d]`` with reads outside
    [0, n) contributing 0.  ``side`` "L": ``matrix`` is applied as
    ``matrix @ P``; "R": as ``P @ matrix`` (stored transposed).  Returns
    ``(offsets, coef)``: the contiguous offset range d0..d1 covering every
    nonzero diagonal (``span``: a given range covering them, as the
    shard slices of one band share), and an (d1 - d0 + 1, n) float32
    table whose row ``d - d0`` holds ``M[p, p + d]`` (0 where p + d
    leaves [0, n))."""
    m = np.asarray(matrix, np.float32)
    if side == "R":
        m = m.T
    n = m.shape[0]
    rows, cols = np.nonzero(m)
    if span is not None:
        d0, d1 = span
    elif rows.size == 0:
        return [0], np.zeros((1, n), np.float32)
    else:
        d0, d1 = int((cols - rows).min()), int((cols - rows).max())
    coef = np.zeros((d1 - d0 + 1, n), np.float32)
    for d in range(d0, d1 + 1):
        p = np.arange(max(0, -d), min(n, n - d))
        coef[d - d0, p] = m[p, p + d]
    return list(range(d0, d1 + 1)), coef


def _normalize(w):
    """Scale a weight vector so its largest-|.| entry is 1 — identical
    *patterns* then share one pooled matrix (and one cached transformed
    plane) across i-offset groups and stages."""
    a = w[int(np.argmax(np.abs(w)))]
    return (w / a, float(a)) if a != 0 else (w, 1.0)


def _band_matrix(n: int, offsets: List[int], weights: List[float],
                 g0: Optional[int] = None, N: Optional[int] = None
                 ) -> np.ndarray:
    """Banded matrix M with M[p, p+o] = w_o (truncated at the window edges —
    exactly the zero-boundary contribution when the window IS the domain).

    With ``g0``/``N``, row p corresponds to global coordinate ``g0 + p`` of
    a domain of size ``N`` (a halo-widened tile/shard plane): entries whose
    source global coordinate leaves [0, N) are zeroed — the origin-aware
    band truncation for tiled/sharded planes.  ``g0=None`` keeps every
    in-window entry (an interior tile, where the exchanged halo provides
    all band sources)."""
    m = np.zeros((n, n), np.float32)
    for o, wt in zip(offsets, weights):
        idx = np.arange(max(0, -o), min(n, n - o))
        if g0 is not None:
            g = g0 + idx + o
            idx = idx[(g >= 0) & (g < N)]
        m[idx, idx + o] = wt
    return m


def plan_linear_stage(kspec: ir.KernelSpec,
                      plane: Tuple[int, int],
                      dims: Tuple[int, int, int],
                      pool: MatrixPool,
                      min_footprint: int = 9,
                      max_rank: int = 2,
                      j_contexts: Optional[List[Optional[int]]] = None,
                      k_contexts: Optional[List[Optional[int]]] = None
                      ) -> Optional[LinearStagePlan]:
    """Build the banded plan for one stage, or None if ineligible.

    Eligibility: affine expression; every accessed array field has a
    constant or shrink BC; footprint at least ``min_footprint``; every
    i-offset group factors with rank <= ``max_rank``.

    ``j_contexts``/``k_contexts``: for sharded planes, the GLOBAL
    coordinate of the widened plane's row/col 0 for every shard instance
    along that dim (None entry = interior instance, no global band edge).
    Matrices and correction planes are then built origin-aware and
    pooled stacked — L over j instances, R over k instances, corrections
    over their cross product (j-major), collapsed back to a single matrix
    when every instance agrees; each shard reads its instance's slice.
    With both None (plane == global domain) matrices are unstacked."""
    coeffs = extract_linear(kspec)
    if coeffs is None:
        return None
    bias = 0.0
    by_field_oi: Dict[Tuple[str, Optional[int]], Dict[Offset2, float]] = {}
    for key, c in coeffs.items():
        if key == ("const",):
            bias += c
            continue
        field, offsets = key
        bc = kspec.boundary_conditions.get(field)
        if bc is not None and bc.kind == ir.BCKind.COPY:
            return None    # copy BC: per-cell path
        oi, oj, ok = offsets
        by_field_oi.setdefault((field, oi), {})[(oj or 0, ok or 0)] = \
            by_field_oi.get((field, oi), {}).get((oj or 0, ok or 0),
                                                 0.0) + c
    footprint = sum(len(v) for v in by_field_oi.values())
    if footprint < min_footprint:
        return None

    pj, pk = plane
    J, K = dims[1], dims[2]

    tiled = j_contexts is not None or k_contexts is not None
    if tiled:
        j_contexts = j_contexts if j_contexts is not None else [None]
        k_contexts = k_contexts if k_contexts is not None else [None]

    def add_band(n, offs, wts, side):
        """Pool one band matrix (or a per-instance stack of them)."""
        if not tiled:
            full = _band_matrix(n, offs, wts)
            if side == "R":   # stored transposed, applied as P @ full
                full = np.ascontiguousarray(full.T)
            return pool.add(full, side)
        ndom = J if side == "L" else K
        slices = []
        for g0 in (j_contexts if side == "L" else k_contexts):
            m = _band_matrix(n, offs, wts, g0=g0,
                             N=ndom if g0 is not None else None)
            slices.append(np.ascontiguousarray(m.T) if side == "R" else m)
        if all(np.array_equal(slices[0], s) for s in slices[1:]):
            return pool.add(slices[0], side)
        return pool.add(np.stack(slices), side + "s")

    groups: List[PlaneGroup] = []
    for (field, oi), cmap in by_field_oi.items():
        ojs = sorted({o[0] for o in cmap})
        oks = sorted({o[1] for o in cmap})
        C = np.zeros((len(ojs), len(oks)), np.float64)
        for (oj, ok), c in cmap.items():
            C[ojs.index(oj), oks.index(ok)] = c
        terms: List[BandTerm] = []
        if not np.any(C):
            continue   # fully cancelled coefficients: zero contribution
        if C.shape == (1, 1) and ojs == [0] and oks == [0]:
            terms.append(BandTerm(None, None, float(C[0, 0])))
        elif len(ojs) == 1 and ojs == [0]:
            nv, b = _normalize(C[0])
            terms.append(BandTerm(None, add_band(pk, oks, list(nv), "R"),
                                  b))
        elif len(oks) == 1 and oks == [0]:
            nu, a = _normalize(C[:, 0])
            terms.append(BandTerm(add_band(pj, ojs, list(nu), "L"), None,
                                  a))
        else:
            u, sv, vt = np.linalg.svd(C)
            rank = int((sv > 1e-10 * max(1.0, sv[0])).sum())
            if rank > max_rank:
                return None
            if rank == 0:
                continue   # numerically zero group
            for m in range(rank):
                nu, a = _normalize(u[:, m])
                nv, b = _normalize(vt[m])
                terms.append(BandTerm(add_band(pj, ojs, list(nu), "L"),
                                      add_band(pk, oks, list(nv), "R"),
                                      float(sv[m] * a * b)))
        wsum = float(sum(cmap.values()))

        # constant-BC correction: j/k-OOB cells contribute bc.value, not 0
        # (per group, so i-OOB replacement composes correctly)
        bc = kspec.boundary_conditions.get(field)
        if bc is not None and bc.kind == ir.BCKind.SHRINK:
            bval = JUNK_VAL   # only affects halo cells (pruned)
        else:
            bval = float(bc.value) if bc is not None else 0.0
        corr_key = None
        if bval != 0.0:
            def corr_for(g0j, g0k):
                jj = (np.arange(pj) +
                      (g0j if g0j is not None else 0))[:, None]
                kk = (np.arange(pk) +
                      (g0k if g0k is not None else 0))[None, :]
                correction = np.zeros((pj, pk), np.float32)
                for (oj, ok), c in cmap.items():
                    oob = np.zeros((pj, pk), bool)
                    if g0j is not None:
                        oob |= (jj + oj < 0) | (jj + oj >= J)
                    if g0k is not None:
                        oob |= (kk + ok < 0) | (kk + ok >= K)
                    correction += np.float32(bval * c) * oob
                return correction
            if not tiled:
                correction = corr_for(0, 0)
                if np.any(correction):
                    corr_key = pool.add(correction, "corr")
            else:
                # cross product, j-major: instance (ji, ki) at ji*nk + ki
                stack = np.stack([corr_for(a, b)
                                  for a in j_contexts for b in k_contexts])
                if np.any(stack):
                    if all(np.array_equal(stack[0], s) for s in stack[1:]):
                        corr_key = pool.add(stack[0], "corr")
                    else:
                        corr_key = pool.add(stack, "corrs")
        groups.append(PlaneGroup(field, oi, terms, wsum, bval, corr_key))

    if not groups:
        # every coefficient group cancelled: a constant stage — the
        # per-cell path emits it
        return None
    return LinearStagePlan(groups=groups, bias=bias, footprint=footprint)
