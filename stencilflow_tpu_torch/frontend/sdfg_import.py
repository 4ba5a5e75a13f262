"""DaCe-SDFG file ingestion (no dace dependency).

The reference's second frontend consumes DaCe SDFG programs whose stencil
computations sit in ``Stencil`` library nodes
(stencilflow/stencil/stencil.py:11-59) and converts them to
the JSON dialect (stencilflow/sdfg_to_stencilflow.py:522-767).
An ``.sdfg`` file IS a JSON document, so the ingestion itself needs no dace:
this module walks the serialized state machine (including nested SDFGs),
collects Stencil library nodes in order, rewrites their relative-offset
code back to absolute ``[i, j+1, k-1]`` indexing (the inverse of the
reference's ``_RenameTransformer._offset_to_index``, :450-461), and feeds
the ordered op list — repeated writes included — through
:func:`~stencilflow_tpu_torch.frontend.canonicalize.program_from_op_list`'s SSA
versioning.

When a state carries dataflow edges (real DaCe-serialized SDFGs), fields
are resolved THROUGH the access-node graph the way the reference does
(``find_input_arraynode``, sdfg_to_stencilflow.py:635-660): each stencil
connector follows its memlet edge chain to the ``AccessNode`` whose
``data`` names the global array — connector names need not match array
names.  Stencil nodes in one state execute in dataflow-topological
order.  Three of the reference's canonicalization passes run on the
serialized graph (sdfg_to_stencilflow.py:71-201): constant scalar
transients written by tasklets become dialect ``constants``
(``remove_scalar_transients``), stencil nodes reading no arrays are
folded to constants (``remove_constant_stencils``), and transient
writes nothing reads are dropped (``remove_unused_sinks``).  Transient
flags on array descriptors drive input/output classification when
present.

General map nests (``MapEntry`` -> tasklet -> ``MapExit`` scopes,
including the NestK shape of a 1-D outer map over a lower-dimensional
body) are desugared into Stencil-style nodes by
:mod:`~stencilflow_tpu_torch.frontend.mapnest` before the walk, playing the
reference's ``MapFission`` -> ``NestK`` -> ``StencilFusion`` pipeline
roles (sdfg_to_stencilflow.py:267-332, stencil/nestk.py:41-176).
States are walked in interstate execution order with edge ASSIGNMENTS
folded into a symbol environment and edge CONDITIONS statically
evaluated (``split_condition_interstate_edges`` role, :252-264; symbol
specialization :291-304) — numeric symbols become dialect constants.

Remaining scope limits (documented, not hidden): the importer has no
dace dependency, so its fixtures are schema-faithful serializations
committed under tests; ``standardize_data_layout``'s
(J,K,I) stride permutation is a memory-layout choice with no semantic
effect on import (we read logical shapes; permuted-stride arrays import
identically).

Targeted serializer version: the CGO'21-era dace the reference pins as
a submodule (spcl/dace ~0.9.x, 2020).  The field set this importer
consumes matches that serializer's JSON layout: top-level
``{"type": "SDFG", "attributes": {...}, "nodes": [states], "edges":
[interstate]}``, per-node ``attributes`` nesting with ``data`` /
``label`` / ``code`` as ``{"string_data", "language"}`` (or a bare
string — both eras accepted), constants as ``[dtype, value]`` pairs,
symbolic shapes as strings, map ranges as ``{"ranges": [{begin, end,
step, tile}]}``, and ``scope_entry/exit`` ids as strings.  The
reference's own converter consumes LIVE dace objects
(sdfg_to_stencilflow.py:522-767), so byte-level serializer quirks past
this field set cannot be cross-checked without dace; anything missing
surfaces as a loud KeyError at import, not silent misparse.

Copied from ``stencilflow_tpu/frontend/sdfg_import.py`` with no change of
meaning: the port cannot import the JAX package, whose ``__init__``
imports jax.
"""
from __future__ import annotations

import ast
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import ir

_ITER = ("i", "j", "k")


def _is_stencil_node(node: dict) -> bool:
    cp = node.get("classpath", "")
    t = node.get("type", "")
    if t == "Stencil" or cp.endswith(".Stencil") or cp == "Stencil":
        return True
    attrs = node.get("attributes", {})
    return ("accesses" in attrs and "output_fields" in attrs
            and "code" in attrs)


def _has_state_loop(sdfg: dict) -> bool:
    """Detect a control-flow back edge in the serialized state machine
    (recursing nested SDFGs).  The reference rejects any remaining loop
    after canonicalization (RemoveLoop, then error at
    stencilflow/sdfg_to_stencilflow.py:281-284)."""
    adj: Dict[str, List[str]] = {}
    for e in sdfg.get("edges", []):
        adj.setdefault(str(e.get("src")), []).append(str(e.get("dst")))
    color: Dict[str, int] = {}
    for root in list(adj):
        if color.get(root, 0):
            continue
        # iterative DFS: unrolled time loops produce thousands of
        # states in a linear chain — recursion would overflow
        stack = [(root, iter(adj.get(root, ())))]
        color[root] = 1
        while stack:
            u, it = stack[-1]
            advanced = False
            for v in it:
                c = color.get(v, 0)
                if c == 1:
                    return True
                if c == 0:
                    color[v] = 1
                    stack.append((v, iter(adj.get(v, ()))))
                    advanced = True
                    break
            if not advanced:
                color[u] = 2
                stack.pop()
    for state in sdfg.get("nodes", []):
        for node in state.get("nodes", []):
            if node.get("type") == "NestedSDFG":
                inner = node.get("attributes", {}).get("sdfg")
                if inner and _has_state_loop(inner):
                    return True
    return False


def _walk_stencil_nodes(sdfg: dict) -> List[dict]:
    """All Stencil library nodes in state order, recursing nested SDFGs
    (reference: the topological order walk, :555-588)."""
    out: List[dict] = []
    for state in sdfg.get("nodes", []):
        for node in state.get("nodes", []):
            if _is_stencil_node(node):
                out.append(node)
            elif node.get("type") == "NestedSDFG":
                inner = node.get("attributes", {}).get("sdfg")
                if inner:
                    out.extend(_walk_stencil_nodes(inner))
    return out


def _code_string(attrs: dict) -> str:
    code = attrs.get("code", "")
    if isinstance(code, dict):
        code = code.get("string_data", "")
    return code


class _AbsoluteIndexer(ast.NodeTransformer):
    """``field[0, 1, -1]`` -> ``field[i, j+1, k-1]`` honoring each field's
    dimension mask (unspanned dims use their own shorter subscripts)."""

    def __init__(self, masks: Dict[str, Tuple[bool, ...]]):
        self.masks = masks

    def visit_Subscript(self, node):
        self.generic_visit(node)
        if not isinstance(node.value, ast.Name):
            return node
        field = node.value.id
        idx = node.slice
        elts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
        offs = []
        for e in elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, int):
                offs.append(e.value)
            elif (isinstance(e, ast.UnaryOp)
                  and isinstance(e.op, ast.USub)
                  and isinstance(e.operand, ast.Constant)
                  and isinstance(e.operand.value, int)):
                offs.append(-e.operand.value)
            else:
                return node   # already absolute / symbolic: leave as-is
        mask = self.masks.get(field, (True,) * len(offs))
        # offsets are per SPANNED dim (stencil.py's accesses example);
        # map them through the field's dim mask to iterator names
        its = [it for it, m in zip(_ITER[3 - len(mask):], mask) if m]
        if len(its) != len(offs):
            its = list(_ITER[3 - len(offs):])
        parts = []
        for it, o in zip(its, offs):
            parts.append(ast.parse(
                it if o == 0 else f"{it}{o:+d}", mode="eval").body)
        new_idx = ast.Tuple(elts=parts, ctx=ast.Load()) \
            if len(parts) > 1 else parts[0]
        return ast.Subscript(value=node.value, slice=new_idx,
                             ctx=node.ctx)


def _rewrite_code(code: str, masks: Dict[str, Tuple[bool, ...]],
                  target: str) -> str:
    """Relative-offset stencil code -> dialect computation string whose
    final assignment targets ``target`` (LHS subscripts dropped — the
    reference's _OutputTransformer, :405-426)."""
    tree = ast.parse(code)
    lines = []
    indexer = _AbsoluteIndexer(masks)
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            raise ValueError(
                f"stencil code must be simple assignments, got "
                f"{type(stmt).__name__}")
        tgt = stmt.targets[0]
        if isinstance(tgt, ast.Subscript):
            tgt = tgt.value
        if not isinstance(tgt, ast.Name):
            raise ValueError("assignment target must be a name")
        rhs = indexer.visit(stmt.value)
        lines.append(f"{tgt.id} = {ast.unparse(rhs)}")
    # the stencil's output connector becomes the op target
    last_lhs = lines[-1].split(" = ")[0]
    if last_lhs != target:
        lines.append(f"{target} = {last_lhs}")
    return "; ".join(lines)


class _Renamer(ast.NodeTransformer):
    """Rename field names (connector -> array data name) in stencil code."""

    def __init__(self, mapping: Dict[str, str]):
        self.mapping = mapping

    def visit_Name(self, node):
        new = self.mapping.get(node.id)
        return ast.copy_location(ast.Name(id=new, ctx=node.ctx),
                                 node) if new else node


def _rename_code(code: str, mapping: Dict[str, str]) -> str:
    if not mapping or all(k == v for k, v in mapping.items()):
        return code
    tree = _Renamer(mapping).visit(ast.parse(code))
    return "; ".join(ast.unparse(stmt) for stmt in tree.body)


def _state_graph(state: dict):
    """(nodes_by_id, in_edges, out_edges) of one serialized state."""
    nodes: Dict[str, dict] = {}
    for i, n in enumerate(state.get("nodes", [])):
        nodes[str(n.get("id", i))] = n
    ine: Dict[str, List[dict]] = {}
    oute: Dict[str, List[dict]] = {}
    for e in state.get("edges", []):
        ine.setdefault(str(e.get("dst")), []).append(e)
        oute.setdefault(str(e.get("src")), []).append(e)
    return nodes, ine, oute


def _is_access_node(node: dict) -> bool:
    return node.get("type") == "AccessNode"


def _node_data(node: dict) -> Optional[str]:
    d = node.get("attributes", {}).get("data")
    return d if isinstance(d, str) else None


def _find_array_node(nodes, edges_by_node, edge, direction: str,
                     limit: int = 64) -> Optional[str]:
    """Follow a memlet edge chain to the AccessNode naming the array —
    the reference's find_input/output_arraynode role
    (sdfg_to_stencilflow.py:635-660).  ``direction``: "in" walks toward
    sources, "out" toward sinks."""
    key = "src" if direction == "in" else "dst"
    for _ in range(limit):
        node = nodes.get(str(edge.get(key)))
        if node is None:
            return None
        if _is_access_node(node):
            return _node_data(node)
        nxt = edges_by_node.get(str(edge.get(key)), [])
        if not nxt:
            return None
        edge = nxt[0]
    return None


def _edge_connector(edge: dict, which: str) -> Optional[str]:
    c = edge.get(which + "_connector")
    if c is None:
        c = edge.get(which + "_conn")
    if isinstance(c, str):
        # dace prefixes connectors of library nodes with IN_/OUT_ in some
        # expansions; stencil nodes use bare field names — strip if present
        for pre in ("IN_", "OUT_"):
            if c.startswith(pre):
                return c[len(pre):]
    return c


def _tasklet_constant(node: dict) -> Optional[float]:
    """The literal a constant tasklet assigns (``out = 3.14``), or None
    (reference remove_scalar_transients, sdfg_to_stencilflow.py:107-160)."""
    if node.get("type") != "Tasklet":
        return None
    code = _code_string(node.get("attributes", {}))
    try:
        tree = ast.parse(code.strip())
    except SyntaxError:
        return None
    if len(tree.body) != 1 or not isinstance(tree.body[0], ast.Assign):
        return None
    val = tree.body[0].value
    if isinstance(val, ast.Constant) and isinstance(val.value,
                                                    (int, float)):
        return float(val.value)
    if (isinstance(val, ast.UnaryOp) and isinstance(val.op, ast.USub)
            and isinstance(val.operand, ast.Constant)
            and isinstance(val.operand.value, (int, float))):
        return -float(val.operand.value)
    return None


def _topo_stencils(state: dict) -> List[Tuple[dict, Dict[str, str],
                                              Optional[str]]]:
    """Stencil nodes of one state in dataflow-topological order, each
    with its connector->array mapping (via access-node resolution) and
    its output array name.  States without edges fall back to listing
    order with identity mappings (attribute-only fixtures)."""
    nodes, ine, oute = _state_graph(state)
    stencils = [(nid, n) for nid, n in nodes.items()
                if _is_stencil_node(n)]
    if not state.get("edges"):
        return [(n, {}, None) for _nid, n in stencils]

    # dataflow order over ALL nodes (stencils interleave with access
    # nodes); Kahn's algorithm on the edge lists
    indeg = {nid: len(ine.get(nid, [])) for nid in nodes}
    ready = sorted([nid for nid, d in indeg.items() if d == 0])
    order: List[str] = []
    while ready:
        nid = ready.pop(0)
        order.append(nid)
        for e in oute.get(nid, []):
            d = str(e.get("dst"))
            indeg[d] -= 1
            if indeg[d] == 0:
                ready.append(d)
    if len(order) != len(nodes):
        raise ValueError("cycle in state dataflow graph")

    out = []
    for nid in order:
        node = nodes[nid]
        if not _is_stencil_node(node):
            continue
        mapping: Dict[str, str] = {}
        for e in ine.get(nid, []):
            conn = _edge_connector(e, "dst")
            data = _find_array_node(nodes, ine, e, "in")
            if conn and data:
                if conn in mapping and mapping[conn] != data:
                    raise ValueError(
                        f"connector {conn!r} resolves to both "
                        f"{mapping[conn]!r} and {data!r}")
                mapping[conn] = data
        out_data = None
        for e in oute.get(nid, []):
            conn = _edge_connector(e, "src")
            data = _find_array_node(nodes, oute, e, "out")
            if conn and data:
                mapping[conn] = data
                out_data = data
        out.append((node, mapping, out_data))
    return out


def _scalar_constants(state: dict, arrays: dict) -> Dict[str, float]:
    """Arrays (scalar transients) assigned a literal by a tasklet in this
    state -> their constant values (remove_scalar_transients)."""
    nodes, _ine, oute = _state_graph(state)
    consts: Dict[str, float] = {}
    for nid, node in nodes.items():
        val = _tasklet_constant(node)
        if val is None:
            continue
        for e in oute.get(nid, []):
            data = _find_array_node(nodes, oute, e, "out")
            if data is None:
                continue
            desc = arrays.get(data, {})
            attrs = desc.get("attributes", {})
            shape = attrs.get("shape", [1])
            is_scalar = (desc.get("type") == "Scalar"
                         or list(shape) in ([1], [], [1, 1]))
            if is_scalar:
                consts[data] = val
    return consts


def _const_eval(code: str, constants: Dict[str, float]) -> float:
    """Evaluate a constant stencil's code (numeric literals, the already-
    collected constants, arithmetic) to one float — the reference's
    remove_constant_stencils (sdfg_to_stencilflow.py:163-201)."""
    import math
    env: Dict[str, float] = dict(constants)
    tree = ast.parse(code)

    def ev(n) -> float:
        if isinstance(n, ast.Constant) and isinstance(n.value,
                                                      (int, float)):
            return float(n.value)
        if isinstance(n, ast.Name):
            if n.id in env:
                return env[n.id]
            raise ValueError(f"constant stencil reads unknown {n.id!r}")
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -ev(n.operand)
        if isinstance(n, ast.BinOp):
            lo, hi = ev(n.left), ev(n.right)
            if isinstance(n.op, ast.Add):
                return lo + hi
            if isinstance(n.op, ast.Sub):
                return lo - hi
            if isinstance(n.op, ast.Mult):
                return lo * hi
            if isinstance(n.op, ast.Div):
                return lo / hi
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
            fn = getattr(math, n.func.id, None)
            if fn is not None and len(n.args) == 1:
                return float(fn(ev(n.args[0])))
        raise ValueError(
            f"unsupported constant expression {ast.dump(n)[:60]}")

    result = None
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            raise ValueError("constant stencil code must be assignments")
        tgt = stmt.targets[0]
        tgt = tgt.value if isinstance(tgt, ast.Subscript) else tgt
        if not isinstance(tgt, ast.Name):
            raise ValueError("assignment target must be a name")
        result = ev(stmt.value)
        env[tgt.id] = result
    if result is None:
        raise ValueError("constant stencil has no assignment")
    return result


def _bc_json(bc: Any) -> Optional[dict]:
    if bc is None:
        return None
    if isinstance(bc, dict):
        kind = bc.get("btype", bc.get("type", "constant"))
        return {"type": kind, "value": float(bc.get("value", 0.0))}
    return None


def sdfg_to_program(source, name: Optional[str] = None,
                    dimensions: Optional[Sequence[int]] = None,
                    input_data: str = "constant:1.0",
                    vectorization: int = 1,
                    symbols: Optional[Dict[str, Any]] = None
                    ) -> ir.Program:
    """Import a serialized DaCe SDFG (path or dict) into a Program.

    ``symbols`` specializes free SDFG symbols to concrete values (the
    reference's specialization step, sdfg_to_stencilflow.py:291-304) —
    they seed the environment that interstate-edge assignments extend
    and map ranges / conditions are evaluated against."""
    if isinstance(source, (str, bytes)):
        with open(source) as f:
            sdfg = json.load(f)
        if name is None:
            name = sdfg.get("attributes", {}).get("name", "sdfg")
    else:
        sdfg = source
        name = name or sdfg.get("attributes", {}).get("name", "sdfg")

    if _has_state_loop(sdfg):
        raise ValueError(
            "SDFG contains a control-flow loop; unroll or canonicalize "
            "it first (the reference rejects loops the same way, "
            "sdfg_to_stencilflow.py:281-284)")

    arrays = dict(sdfg.get("attributes", {}).get("_arrays", {}))
    arrays.update(sdfg.get("attributes", {}).get("arrays", {}))

    def array_dtype(field, default="float32"):
        desc = arrays.get(field, {}).get("attributes", {})
        dt = desc.get("dtype", default)
        return dt if isinstance(dt, str) else default

    def is_transient(field) -> Optional[bool]:
        desc = arrays.get(field, {}).get("attributes", {})
        t = desc.get("transient")
        return bool(t) if t is not None else None

    # symbol environment: SDFG constants_prop + caller specialization;
    # interstate-edge assignments extend it during the ordered walk
    from .mapnest import order_states, synthesize_map_nests
    env: Dict[str, Any] = {}
    cp = sdfg.get("attributes", {}).get("constants_prop", {}) or {}
    for k, v in cp.items():
        if isinstance(v, (list, tuple)) and len(v) == 2:
            v = v[1]   # dace serializes constants as [dtype, value]
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            env[k] = v
    if symbols:
        env.update(symbols)

    def eval_shape(shp) -> Optional[List[int]]:
        """Resolve a serialized shape: ints, or dace's symbolic strings
        (["I", "J", "K"]) evaluated through constants_prop/specialized
        symbols (canonicalize_sdfg's -symbols role)."""
        if not shp:
            return None
        from .mapnest import eval_sym
        out = []
        for s in shp:
            try:
                out.append(int(s))
                continue
            except (TypeError, ValueError):
                pass
            try:
                v = eval_sym(str(s), env)
            except (ValueError, SyntaxError):
                return None   # unresolved symbolic shape
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                return None
            if v != int(v):   # fractional (e.g. "I/2" with odd I):
                return None   # don't silently floor a wrong dimension
            out.append(int(v))
        return out

    def shape_of(field: str) -> Optional[List[int]]:
        return eval_shape(
            arrays.get(field, {}).get("attributes", {}).get("shape"))

    # canonicalization pass 1 (remove_scalar_transients): constant
    # scalar transients become dialect constants
    constants: Dict[str, float] = {}

    def walk(sub) -> List[Tuple[dict, Dict[str, str], Optional[str]]]:
        got: List[Tuple[dict, Dict[str, str], Optional[str]]] = []
        for state, senv in order_states(sub, env):
            state = synthesize_map_nests(state, senv, shape_of=shape_of)
            constants.update(_scalar_constants(state, arrays))
            got.extend(_topo_stencils(state))
            for node in state.get("nodes", []):
                if node.get("type") == "NestedSDFG":
                    inner = node.get("attributes", {}).get("sdfg")
                    if inner:
                        got.extend(walk(inner))
        return got

    resolved = walk(sdfg)
    # symbol specialization: numeric symbols the walk accumulated become
    # dialect constants readable from stencil code
    for k, v in env.items():
        if (isinstance(v, (int, float)) and not isinstance(v, bool)
                and k not in arrays):
            constants.setdefault(k, float(v))
    if not resolved:
        raise ValueError("no Stencil library nodes found in the SDFG")

    ops = []
    op_reads: List[List[str]] = []
    masks_all: Dict[str, Tuple[bool, ...]] = {}
    written: List[str] = []
    shapes: List[List[int]] = []
    for node, mapping, out_data in resolved:
        attrs = node.get("attributes", {})
        accesses = attrs.get("accesses", {})
        outs = list(attrs.get("output_fields", {}))
        if len(outs) != 1:
            raise ValueError(
                f"stencil node {attrs.get('label')!r} must have exactly "
                f"one output field, got {outs}")
        target = mapping.get(outs[0], out_data or outs[0])
        got_shape = eval_shape(attrs.get("shape") or [])
        if got_shape:
            shapes.append(got_shape)
        masks = {}
        reads = []
        for f, acc in accesses.items():
            data = mapping.get(f, f)
            if data in constants:
                continue   # constant scalar: resolved by the parser
            mask = tuple(bool(m) for m in acc[0])
            if data in masks and masks[data] != mask:
                raise ValueError(
                    f"field {data!r} reaches {attrs.get('label')!r} "
                    "through two connectors with different dim masks")
            masks[data] = mask
            masks_all.setdefault(data, mask)
            reads.append(data)
        bcs = {}
        node_bcs = attrs.get("boundary_conditions", {})
        for f, bc in node_bcs.items():
            data = mapping.get(f, f)
            if data in constants:
                continue
            j = _bc_json(bc)
            if j is not None:
                bcs[data] = j
        # a read field with no (or None) BC inherits the OUTPUT's BC —
        # the reference's defaulting rule (sdfg_to_stencilflow.py:681-685)
        out_bc = _bc_json(node_bcs.get(outs[0]))
        if out_bc is not None:
            for f in reads:
                bcs.setdefault(f, dict(out_bc))
        code = _rename_code(_code_string(attrs),
                            {f: d for f, d in mapping.items() if f != d})
        # canonicalization pass 2 (remove_constant_stencils): a node
        # reading no arrays folds to a constant
        if not reads:
            constants[target] = _const_eval(code, constants)
            continue
        code = _rewrite_code(code, masks, target)
        ops.append((target, code, bcs, array_dtype(target)))
        op_reads.append(reads)
        written.append(target)
        masks_all.setdefault(target, (True, True, True))

    # canonicalization pass 3 (remove_unused_sinks): transient writes
    # nothing ever reads are dropped (iterate: dropping one can orphan
    # its producers)
    while True:
        drop = None
        for idx in range(len(ops) - 1, -1, -1):
            t = ops[idx][0]
            if is_transient(t) is not True:
                continue
            if idx != len(written) - 1 - written[::-1].index(t):
                continue   # not the last write of t: earlier versions
                #            are read through SSA, leave them
            if any(t in r for r in op_reads[idx + 1:]):
                continue
            drop = idx
            break
        if drop is None:
            break
        del ops[drop], op_reads[drop], written[drop]

    if dimensions is None:
        if not shapes:
            raise ValueError("SDFG carries no concrete shapes; pass "
                             "dimensions=")
        # align mixed-rank shapes by TRAILING dims (a 2-D field maps to
        # the (j, k) iterators, _ITER[3-rank:], like everywhere else in
        # the importer) — leading-aligned max would fold a 2-D shape's J
        # into the global i extent
        rank = max(len(s) for s in shapes)
        dimensions = [
            max((s[len(s) - rank + d] for s in shapes
                 if len(s) - rank + d >= 0), default=1)
            for d in range(rank)]

    written_set = set(written)
    # fields still referenced after the unused-sink drops (a dropped
    # transient target must not resurface as a phantom input)
    used = set(written)
    for reads in op_reads:
        used.update(reads)
    inputs: Dict[str, dict] = {}
    for f, mask in masks_all.items():
        if f in written_set or f not in used:
            continue
        spec: Dict[str, Any] = {"data": input_data,
                                "data_type": array_dtype(f)}
        if not all(mask):
            rank = len(dimensions)
            its = _ITER[3 - rank:]
            spec["input_dims"] = [it for it, m in zip(its, mask) if m]
        inputs[f] = spec

    # outputs: transient flags decide when the descriptors carry them
    # (the reference keys on sdfg.arrays[...].transient); else every
    # written name whose final version nothing later reads (the
    # versioning keeps the bare name on the last write)
    read_later: Dict[str, int] = {}
    for idx, reads in enumerate(op_reads):
        for f in reads:
            read_later[f] = idx
    last_write = {t: idx for idx, (t, *_rest) in enumerate(ops)}
    flagged = [t for t in last_write if is_transient(t) is not None]
    outputs = [t for t in last_write if is_transient(t) is False]
    if not outputs:
        if flagged and len(flagged) == len(last_write):
            raise ValueError("every written array is transient: the "
                             "SDFG has no program outputs")
        outputs = [t for t, lw in last_write.items()
                   if read_later.get(t, -1) <= lw]

    from .canonicalize import program_from_op_list
    return program_from_op_list(ops, dimensions, inputs, outputs,
                                name=name, constants=constants or None,
                                vectorization=vectorization)
