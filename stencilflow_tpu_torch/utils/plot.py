"""Graph plotting: kernel-chain DAG and per-kernel compute DAG to PNG.

Reference counterpart: graphviz/matplotlib plotting in
kernel_chain_graph.py:162-241 and compute_graph.py:346-447.  We use only
matplotlib (no graphviz system dependency): nodes are laid out by
topological layer.

Copied from ``stencilflow_tpu/utils/plot.py`` with no change of meaning:
the port cannot import the JAX package, whose ``__init__`` imports jax.
matplotlib is imported inside the two plot functions only, so this module
imports where matplotlib is not installed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import ir
from ..frontend.chain import ChainGraph


def _layers(graph: ChainGraph) -> Dict[str, int]:
    """Topological depth per node (inputs at 0)."""
    depth: Dict[str, int] = {}
    for node in graph.order:
        preds = graph.producers(node) if node in graph.program.kernels \
            else []
        depth[node] = 1 + max((depth[p] for p in preds), default=-1)
    return depth


def chain_graph_dot(program: ir.Program,
                    graph: Optional[ChainGraph] = None) -> str:
    """Graphviz DOT text of the program DAG (the reference plots through
    graphviz; we emit the text for external tooling)."""
    graph = graph or ChainGraph.build(program)
    lines = [f'digraph "{program.name}" {{', "  rankdir=LR;"]
    for n in graph.order:
        if n in program.inputs:
            shape, color = "box", "lightblue"
        elif n in program.outputs:
            shape, color = "ellipse", "lightgreen"
        else:
            shape, color = "ellipse", "orange"
        lines.append(f'  "{n}" [shape={shape}, style=filled, '
                     f'fillcolor={color}];')
    for u, v in graph.edge_list():
        lines.append(f'  "{u}" -> "{v}";')
    lines.append("}")
    return "\n".join(lines)


def plot_chain_graph(program: ir.Program, path: str,
                     graph: Optional[ChainGraph] = None) -> str:
    """Render the program DAG (inputs → kernels → outputs) to ``path``
    (.dot suffix emits Graphviz text; anything else renders a PNG)."""
    if path.endswith(".dot"):
        with open(path, "w") as f:
            f.write(chain_graph_dot(program, graph))
        return path
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    graph = graph or ChainGraph.build(program)
    depth = _layers(graph)
    by_layer: Dict[int, List[str]] = {}
    for n, d in depth.items():
        by_layer.setdefault(d, []).append(n)
    pos: Dict[str, Tuple[float, float]] = {}
    for d, nodes in by_layer.items():
        for i, n in enumerate(sorted(nodes)):
            pos[n] = (d, -(i - (len(nodes) - 1) / 2))

    fig, ax = plt.subplots(
        figsize=(2 + 1.6 * (max(by_layer) + 1),
                 2 + 0.9 * max(len(v) for v in by_layer.values())))
    for u, v in graph.edge_list():
        (x0, y0), (x1, y1) = pos[u], pos[v]
        ax.annotate("", xy=(x1, y1), xytext=(x0, y0),
                    arrowprops=dict(arrowstyle="->", color="0.5", lw=1.2))
    for n, (x, y) in pos.items():
        if n in program.inputs:
            color, shape = "#9ecae1", "s"
        elif n in program.outputs:
            color, shape = "#a1d99b", "o"
        else:
            color, shape = "#fdae6b", "o"
        ax.scatter([x], [y], s=1600, c=color, marker=shape, zorder=3,
                   edgecolors="0.3")
        ax.annotate(n, (x, y), ha="center", va="center", zorder=4,
                    fontsize=9)
    ax.set_title(f"{program.name}: kernel chain")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_compute_graph(kspec: ir.KernelSpec, path: str) -> str:
    """Render one kernel's expression DAG to ``path``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nodes: List[Tuple[int, str, int]] = []   # (id, label, depth)
    edges: List[Tuple[int, int]] = []

    def walk(expr: ir.Expr, depth: int) -> int:
        nid = len(nodes)
        if isinstance(expr, ir.Const):
            label = repr(expr.value)
            children = []
        elif isinstance(expr, ir.Ref):
            label, children = expr.name, []
        elif isinstance(expr, ir.Access):
            label, children = repr(expr), []
        elif isinstance(expr, ir.BinOp):
            label = {"add": "+", "sub": "-", "mult": "*",
                     "div": "/"}[expr.op]
            children = [expr.left, expr.right]
        elif isinstance(expr, ir.UnaryOp):
            label, children = "neg", [expr.operand]
        elif isinstance(expr, ir.Compare):
            label, children = expr.op, [expr.left, expr.right]
        elif isinstance(expr, ir.BoolOp):
            label, children = expr.op, list(expr.operands)
        elif isinstance(expr, ir.Select):
            label = "select"
            children = [expr.cond, expr.if_true, expr.if_false]
        elif isinstance(expr, ir.Call):
            label, children = expr.fn, list(expr.args)
        else:
            label, children = type(expr).__name__, []
        nodes.append((nid, label, depth))
        for c in children:
            cid = walk(c, depth + 1)
            edges.append((nid, cid))
        return nid

    roots = []
    for stmt in kspec.statements:
        rid = len(nodes)
        nodes.append((rid, f"{stmt.lhs} =", 0))
        cid = walk(stmt.rhs, 1)
        edges.append((rid, cid))
        roots.append(rid)

    by_depth: Dict[int, List[int]] = {}
    for nid, _label, d in nodes:
        by_depth.setdefault(d, []).append(nid)
    pos: Dict[int, Tuple[float, float]] = {}
    for d, ids in by_depth.items():
        for i, nid in enumerate(ids):
            pos[nid] = (i - (len(ids) - 1) / 2, -d)

    fig, ax = plt.subplots(
        figsize=(2 + 1.3 * max(len(v) for v in by_depth.values()),
                 2 + 1.1 * (max(by_depth) + 1)))
    for u, v in edges:
        (x0, y0), (x1, y1) = pos[u], pos[v]
        ax.plot([x0, x1], [y0, y1], color="0.6", lw=1.0, zorder=1)
    for nid, label, _d in nodes:
        x, y = pos[nid]
        ax.scatter([x], [y], s=1200, c="#dadaeb", zorder=2,
                   edgecolors="0.3")
        ax.annotate(label, (x, y), ha="center", va="center", fontsize=8,
                    zorder=3)
    ax.set_title(f"compute graph: {kspec.name}")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
