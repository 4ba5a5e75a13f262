"""Affine-run composition: collapse t consecutive separable affine stages
into ONE wider banded stage.

Copied from ``stencilflow_tpu/backend/compose.py``, cut to the planes the
port's stream kernel reads (the whole plane, or a shard's widened plane
with the reference's origin contexts), with no change of meaning.  A
stage whose coefficient tensor factors as an outer product

    out = sum_{di,dj,dk} a[di] * u[dj] * v[dk] * src[x + (di,dj,dk)]

is a separable operator ``A(T_i) o (Bj(u) (x) Bk(v))``.  Because the
three axes commute, a RUN of such stages composes exactly into
``(prod_s A_s(T~_i)) o ((prod_s Bj_s) (x) (prod_s Bk_s))``, computed at
compile time: the j/k products are matrix products of the per-stage
truncated bands (exact constant-0 boundary semantics, including the
near-edge rows where truncated products differ from plain coefficient
convolution), and the i-product is an (I x I) banded matrix whose
interior rows are shift-invariant and whose first/last D rows are shipped
to the kernel as a small weight table indexed by the output plane.

Eligibility (everything else is planned per stage):
  * every stage affine, bias 0, f32, reading ONLY the previous stage's
    field (pure chain, interior stages not program outputs);
  * coefficient tensor rank-1 separable (jacobi's cross is not);
  * boundary conditions constant-0 or shrink.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import ir
from .linear import MatrixPool, extract_linear

MAX_DENSE_N = 8192          # j/k band products are banded-diag, dense only
#                             at pool time; refuse absurd planes outright


class BandMat:
    """(n x n) matrix stored as {offset: diagonal}, diagonal d holding
    entries M[p, p+d] for p in [max(0,-d), n-|max(d,0)|) — truncation at
    the domain edge is the natural representation.  Near-edge deviations
    of PRODUCTS from plain convolution live in the varying diagonal
    values, not in extra structure."""

    def __init__(self, n: int, diags: Dict[int, np.ndarray]):
        self.n = n
        self.diags = {d: np.asarray(v, np.float64) for d, v in diags.items()
                      if np.any(v)}

    @classmethod
    def from_profile(cls, n: int, prof: Dict[int, float]) -> "BandMat":
        out = {}
        for o, w in prof.items():
            ln = n - abs(o)
            if ln > 0 and w != 0.0:
                out[o] = np.full(ln, float(w), np.float64)
        return cls(n, out)

    def __matmul__(self, other: "BandMat") -> "BandMat":
        assert self.n == other.n
        n = self.n
        acc: Dict[int, np.ndarray] = {}
        # C[p, p+dc] = sum_{da+db=dc} A[p, p+da] * B[p+da, p+da+db]
        for da, va in self.diags.items():
            for db, vb in other.diags.items():
                dc = da + db
                if abs(dc) >= n:
                    continue
                lo = max(0, -da, -dc)          # valid p range of the product
                hi = min(n, n - da, n - da - db)
                if hi <= lo:
                    continue
                p = np.arange(lo, hi)
                term = va[p - max(0, -da)] * vb[(p + da) - max(0, -db)]
                tgt = acc.setdefault(dc, np.zeros(n - abs(dc), np.float64))
                tgt[p - max(0, -dc)] += term
        return BandMat(n, acc)

    def window(self, g0: int, size: int, dtype=np.float32) -> np.ndarray:
        """Dense ``M[g0:g0+size, g0:g0+size]`` with out-of-domain rows and
        columns zero (the whole matrix at g0 = 0, size = n; a shard's
        widened window otherwise)."""
        m = np.zeros((size, size), np.float64)
        for d, v in self.diags.items():
            rows = np.arange(max(0, -d), self.n - max(0, d))
            cols = rows + d
            sel = ((rows >= g0) & (rows < g0 + size)
                   & (cols >= g0) & (cols < g0 + size))
            m[rows[sel] - g0, cols[sel] - g0] = v[sel]
        return m.astype(dtype)


@dataclasses.dataclass
class StageFactor:
    """One stage as a separable operator a (x) u (x) v over one field."""
    field: str
    iprof: Dict[int, float]
    jprof: Dict[int, float]
    kprof: Dict[int, float]
    shrink: bool
    mask: Tuple[bool, bool, bool]   # offset-None pattern of the source


def separable_factor(kspec: ir.KernelSpec) -> Optional[StageFactor]:
    """Rank-1 (outer-product) factorization of an affine stage, or None."""
    coeffs = extract_linear(kspec)
    if coeffs is None:
        return None
    if abs(coeffs.get(("const",), 0.0)) != 0.0:
        return None                      # bias does not compose cheaply
    fields = {k[0] for k in coeffs if k != ("const",)}
    if len(fields) != 1:
        return None
    field = next(iter(fields))
    bc = kspec.boundary_conditions.get(field)
    shrink = bc is not None and bc.kind == ir.BCKind.SHRINK
    if bc is not None and not shrink and (
            bc.kind != ir.BCKind.CONSTANT or bc.value != 0.0):
        return None                      # nonzero-constant / copy BCs
    entries = [(k[1], c) for k, c in coeffs.items() if k != ("const",)]
    masks = {tuple(o is None for o in offs) for offs, _c in entries}
    if len(masks) != 1:
        return None
    mask = tuple(not m for m in next(iter(masks)))   # spanned dims
    dense = {tuple(0 if o is None else o for o in offs): c
             for offs, c in entries}
    dis = sorted({o[0] for o in dense})
    djs = sorted({o[1] for o in dense})
    dks = sorted({o[2] for o in dense})
    C = np.zeros((len(dis), len(djs), len(dks)), np.float64)
    for (di, dj, dk), c in dense.items():
        C[dis.index(di), djs.index(dj), dks.index(dk)] = c
    if not np.any(C):
        return None
    ai, aj, ak = np.unravel_index(np.argmax(np.abs(C)), C.shape)
    piv = C[ai, aj, ak]
    a = C[:, aj, ak]                     # carries the overall scale
    u = C[ai, :, ak] / piv
    v = C[ai, aj, :] / piv
    if not np.allclose(C, a[:, None, None] * u[None, :, None]
                       * v[None, None, :],
                       rtol=0.0, atol=1e-12 * abs(piv)):
        return None
    return StageFactor(
        field=field,
        iprof={d: float(w) for d, w in zip(dis, a) if w != 0.0},
        jprof={d: float(w) for d, w in zip(djs, u) if w != 0.0},
        kprof={d: float(w) for d, w in zip(dks, v) if w != 0.0},
        shrink=shrink, mask=mask)


@dataclasses.dataclass
class ComposedBuild:
    """Compile-time recipe for one composed segment."""
    name: str                     # kernel name (the run's LAST stage)
    stages: List[str]             # replaced stage names, chain order
    field: str                    # the run's source field
    factors: List[StageFactor]
    dtype: np.dtype
    shrink: bool
    ioffs: List[int]              # composed i-offsets (interior footprint)
    joffs: List[int]
    koffs: List[int]
    mask: Tuple[bool, bool, bool]


@dataclasses.dataclass
class ComposedPlan:
    """Kernel-consumable plan: one (L, R) transform per source plane plus
    an i-weight table (interior row + the first/last D boundary rows of
    the exact composed i-matrix), selected per output plane."""
    field: str
    offsets: Tuple[int, ...]      # i-offsets, ascending; table columns
    lkey: Optional[str]
    rkey: Optional[str]
    table_key: str
    table_rows: int               # min(I, 2D+1)
    full_table: bool              # True: row index IS the plane index
    D: int
    ilen: int


def _conv(profiles: Sequence[Dict[int, float]]) -> Dict[int, float]:
    acc = {0: 1.0}
    for p in profiles:
        nxt: Dict[int, float] = {}
        for d1, w1 in acc.items():
            for d2, w2 in p.items():
                nxt[d1 + d2] = nxt.get(d1 + d2, 0.0) + w1 * w2
        acc = {d: w for d, w in nxt.items() if w != 0.0}
    return acc


def _balanced_sum(terms: List[ir.Expr]) -> ir.Expr:
    while len(terms) > 1:
        terms = [ir.BinOp("add", terms[i], terms[i + 1])
                 if i + 1 < len(terms) else terms[i]
                 for i in range(0, len(terms), 2)]
    return terms[0]


def find_runs(program: ir.Program, analysis) -> Tuple[
        List[List[str]], Dict[str, StageFactor]]:
    """Maximal composable chains: consecutive separable stages where each
    interior stage's ONLY consumer is the next stage."""
    factors: Dict[str, StageFactor] = {}
    for name, kspec in program.kernels.items():
        if np.dtype(kspec.dtype) != np.float32:
            continue
        f = separable_factor(kspec)
        if f is not None and np.dtype(program.field_dtype(f.field)
                                      ) == np.float32:
            factors[name] = f
    runs: List[List[str]] = []
    used: set = set()
    for name in analysis.graph.kernel_order:
        if name in used or name not in factors:
            continue
        run = [name]
        used.add(name)
        cur = name
        while cur not in program.outputs:
            cons = [c for c in analysis.graph.consumers(cur)
                    if c in program.kernels]
            if len(cons) != 1:
                break
            nxt = cons[0]
            if (nxt in used or nxt not in factors
                    or factors[nxt].field != cur
                    or factors[nxt].mask != factors[name].mask):
                break
            run.append(nxt)
            used.add(nxt)
            cur = nxt
        if len(run) >= 2:
            runs.append(run)
    return runs, factors


def compose_program(program: ir.Program, analysis,
                    max_t: int = 0) -> Optional[Tuple[
                        ir.Program, Dict[str, ComposedBuild]]]:
    """Rewritten program with composable runs collapsed, plus the per-
    segment builds, or None when nothing composes.  ``max_t`` caps the
    segment length (0 = auto: whole run, bounded by the i-extent gate).

    The rewritten kernel's IR expression is the INTERIOR composed
    operator (plain coefficient convolution, balanced sum) — exact away
    from boundaries and carrying the true composed access footprint for
    ring/halo analysis.  The exact-everywhere semantics live in the
    ComposedPlan the stream kernel executes; the stream planner never
    evaluates that IR."""
    runs, factors = find_runs(program, analysis)
    if not runs:
        return None
    I = program.dimensions[0]
    builds: Dict[str, ComposedBuild] = {}
    replaced: Dict[str, str] = {}       # stage -> segment name
    for run in runs:
        # segment the run: D grows by the per-stage i-radius; the edge
        # table needs 2D+1 distinct rows mapped from I planes
        segs: List[List[str]] = []
        seg: List[str] = []
        D = 0
        for name in run:
            r = max((abs(d) for d in factors[name].iprof), default=0)
            tcap = max_t if max_t > 0 else len(run)
            if seg and (2 * (D + r) + 2 > I or len(seg) >= tcap):
                segs.append(seg)
                seg, D = [], 0
            seg.append(name)
            D += r
        segs.append(seg)
        for seg in segs:
            if len(seg) < 2:
                continue
            name = seg[-1]
            fs = [factors[s] for s in seg]
            builds[name] = ComposedBuild(
                name=name, stages=list(seg), field=fs[0].field,
                factors=fs, dtype=program.kernels[name].dtype,
                shrink=any(f.shrink for f in fs),
                ioffs=sorted(_conv([f.iprof for f in fs])),
                joffs=sorted(_conv([f.jprof for f in fs])),
                koffs=sorted(_conv([f.kprof for f in fs])),
                mask=fs[0].mask)
            for s in seg:
                replaced[s] = name
    if not builds:
        return None

    # rewritten program: interior-composed IR per segment
    new_kernels: Dict[str, ir.KernelSpec] = {}
    for kname, kspec in program.kernels.items():
        if kname not in replaced:
            new_kernels[kname] = kspec
            continue
        seg_name = replaced[kname]
        if kname != seg_name:
            continue                     # interior stage: elided
        b = builds[seg_name]
        ic = _conv([f.iprof for f in b.factors])
        jc = _conv([f.jprof for f in b.factors])
        kc = _conv([f.kprof for f in b.factors])
        mi, mj, mk = b.mask
        terms = []
        for di, wi in sorted(ic.items()):
            for dj, wj in sorted(jc.items()):
                for dk, wk in sorted(kc.items()):
                    offs = (di if mi else None, dj if mj else None,
                            dk if mk else None)
                    terms.append(ir.BinOp(
                        "mult", ir.Const(float(wi * wj * wk)),
                        ir.Access(b.field, offs)))
        bc = ir.BoundaryCondition(
            ir.BCKind.SHRINK if b.shrink else ir.BCKind.CONSTANT, 0.0)
        new_kernels[seg_name] = ir.KernelSpec(
            name=seg_name,
            statements=[ir.Assign(seg_name, _balanced_sum(terms))],
            dtype=b.dtype,
            boundary_conditions={b.field: bc},
            source=f"composed({' -> '.join(b.stages)})")
    new_program = dataclasses.replace(program, kernels=new_kernels)
    return new_program, builds


def _compose_axis(profiles: List[Dict[int, float]], n: int) -> BandMat:
    acc = BandMat.from_profile(n, profiles[0])
    for p in profiles[1:]:
        acc = BandMat.from_profile(n, p) @ acc   # later stage on the left
    return acc


def _i_table(build: ComposedBuild, I: int) -> Optional[Tuple[
        np.ndarray, Tuple[int, ...], int, bool]]:
    """(table, offsets, D, full) — the exact composed i-weights.  Row r of
    the table holds M[p, p+d] for the plane p that maps to r (kernel
    mapping: p < D -> p; p >= I-D -> 2D+1+p-I; else D), or one row per
    plane when I <= 2D+1 (full=True)."""
    # column set: the TRUNCATED product's actual diagonals, not the
    # interior convolution — an interior weight can cancel exactly while
    # the boundary-truncated product keeps nonzero entries on that
    # diagonal
    M = _compose_axis([f.iprof for f in build.factors], I)
    offs = tuple(sorted(set(build.ioffs)
                        | {d for d, diag in M.diags.items()
                           if np.any(diag)}))
    D = max((abs(d) for d in offs), default=0)
    if I <= 2 * D + 1:
        rows, full = list(range(I)), True
    else:
        rows = list(range(D)) + [D] + list(range(I - D, I))
        full = False
    tab = np.zeros((len(rows), len(offs)), np.float64)
    for r, p in enumerate(rows):
        for c, d in enumerate(offs):
            q = p + d
            if 0 <= q < I:
                diag = M.diags.get(d)
                if diag is not None:
                    tab[r, c] = diag[p - max(0, -d)]
    return tab.astype(np.float32), offs, D, full


def plan_composed(build: ComposedBuild, plane: Tuple[int, int],
                  dims: Tuple[int, int, int], pool: MatrixPool,
                  j_contexts=None, k_contexts=None
                  ) -> Optional[ComposedPlan]:
    """ComposedPlan for one segment over the whole (J, K) plane, or over
    one halo-widened shard plane per context (``j_contexts`` /
    ``k_contexts``: the global coordinate of each instance's row/col 0,
    as ``linear.plan_linear_stage`` takes them; the bands are pooled
    stacked unless every instance agrees), or None when the geometry
    refuses (giant planes)."""
    I, J, K = dims
    pj, pk = plane
    if max(J, K) > MAX_DENSE_N:
        return None
    got = _i_table(build, I)
    if got is None:
        return None
    table, offsets, D, full = got

    tiled = j_contexts is not None or k_contexts is not None
    j_contexts = j_contexts if j_contexts is not None else [None]
    k_contexts = k_contexts if k_contexts is not None else [None]

    def side_key(profiles, n_dom, n_plane, contexts, side):
        if all(p == {0: 1.0} for p in profiles):
            return None
        M = _compose_axis(profiles, n_dom)
        slices = []
        for g0 in contexts:
            m = M.window(g0 if g0 is not None else 0, n_plane)
            slices.append(np.ascontiguousarray(m.T) if side == "R" else m)
        if all(np.array_equal(slices[0], s) for s in slices[1:]):
            return pool.add(slices[0], side)
        return pool.add(np.stack(slices), side + "s")

    lkey = side_key([f.jprof for f in build.factors], J, pj,
                    j_contexts if tiled else [None], "L")
    rkey = side_key([f.kprof for f in build.factors], K, pk,
                    k_contexts if tiled else [None], "R")
    table_key = pool.add(table, "itab")
    return ComposedPlan(field=build.field, offsets=offsets, lkey=lkey,
                        rkey=rkey, table_key=table_key,
                        table_rows=table.shape[0], full_table=full,
                        D=D, ilen=I)
