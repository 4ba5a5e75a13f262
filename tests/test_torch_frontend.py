"""The port's front half against the JAX package's, on the CPU.

stencilflow_tpu_torch carries its own copies of the parser, chain graph,
analyses, data loading, synthesizer and numpy oracle (it cannot import
stencilflow_tpu, whose __init__ imports jax).  These tests hold each copy
to the original on the same programs and seeds — exact equality
throughout (the oracle comparison is np.array_equal: both are numpy) —
and enforce that the port imports nothing of JAX.
"""
import ast
import json
import os

import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu_torch as port
import stencilflow_tpu_torch.examples as port_examples
from stencilflow_tpu_torch.synthesize import random_program
from test_fuzz import make_random_program

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = [os.path.join(ROOT, "examples", f) for f in
            sorted(os.listdir(os.path.join(ROOT, "examples")))
            if f.endswith(".json")]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "stencilflow_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "stencilflow_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    """AST scan: no import of jax, ml_dtypes or the JAX package."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {n}"


def _small(path, size=8):
    spec = json.load(open(path))
    spec["dimensions"] = [min(d, size) for d in spec["dimensions"]]
    return spec


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_parse_and_analysis_match(path):
    """Same IR, chain order, halos and delay analysis as the JAX package."""
    a, b = ref.parse_program(path), port.parse_program(path)
    assert a.dimensions == b.dimensions and a.outputs == b.outputs
    assert list(a.kernels) == list(b.kernels)
    for k in a.kernels:
        ka, kb = a.kernels[k], b.kernels[k]
        assert repr(ka.statements) == repr(kb.statements)
        assert np.dtype(ka.dtype) == np.dtype(kb.dtype)
        assert {f: (bc.kind.value, bc.value)
                for f, bc in ka.boundary_conditions.items()} == \
            {f: (bc.kind.value, bc.value)
             for f, bc in kb.boundary_conditions.items()}
    for n in a.inputs:
        assert a.inputs[n].dim_mask == b.inputs[n].dim_mask
        assert np.dtype(a.inputs[n].dtype) == np.dtype(b.inputs[n].dtype)
    an, bn = ref.ChainAnalysis.run(a), port.ChainAnalysis.run(b)
    assert an.graph.order == bn.graph.order
    assert an.stage_halo() == bn.stage_halo()
    assert an.input_halo() == bn.input_halo()
    assert an.critical_path_cycles == bn.critical_path_cycles
    assert {k: (e.delay_size, e.internal_size) for k, e in an.edges.items()} \
        == {k: (e.delay_size, e.internal_size) for k, e in bn.edges.items()}
    # the analytic counters the report reads
    assert an.operation_counts() == bn.operation_counts()
    assert an.minimum_communication_volume() == \
        bn.minimum_communication_volume()
    assert an.runtime_lower_bound() == bn.runtime_lower_bound()
    assert an.fast_memory_elements() == bn.fast_memory_elements()
    assert an.fast_memory_bytes() == bn.fast_memory_bytes()
    assert {k: (e.total_elements, e.total_bytes())
            for k, e in an.edges.items()} == \
        {k: (e.total_elements, e.total_bytes()) for k, e in bn.edges.items()}


@pytest.mark.parametrize("seed", range(6))
def test_inputs_and_oracle_match(seed):
    """Weights and state: the same program and seed give the same input
    arrays in both packages, and the port's numpy oracle gives the same
    outputs as the JAX package's, bit for bit."""
    spec = make_random_program(np.random.default_rng(seed), seed)
    a, b = ref.parse_program(spec), port.parse_program(spec)
    ia, ib = (ref.load_input_arrays(a, seed=seed),
              port.load_input_arrays(b, seed=seed))
    for n in ia:
        assert np.array_equal(np.asarray(ia[n]), np.asarray(ib[n]))
        assert np.asarray(ia[n]).dtype == np.asarray(ib[n]).dtype
    ra, rb = ref.run_interpreter(a, ia), port.run_interpreter(b, ib)
    for o in ra:
        assert np.array_equal(np.asarray(ra[o]), np.asarray(rb[o]))


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_example_oracle_matches(path):
    spec = _small(path)
    a, b = ref.parse_program(spec), port.parse_program(spec)
    ia = ref.load_input_arrays(a, seed=2)
    ra, rb = ref.run_interpreter(a, ia), port.run_interpreter(b, ia)
    for o in ra:
        assert np.array_equal(np.asarray(ra[o]), np.asarray(rb[o]))


@pytest.mark.parametrize("seed", range(8))
def test_random_program_is_the_fuzz_generator(seed):
    """With default arguments the port's generator draws exactly what
    tests/test_fuzz.py draws (chip_smoke.py uses it on the card)."""
    assert random_program(np.random.default_rng(seed)) == \
        make_random_program(np.random.default_rng(seed), seed)


def test_synthesize_matches():
    from stencilflow_tpu import synthesize as rs
    from stencilflow_tpu_torch import synthesize as ps
    for shape in ("diffusion", "hotspot", "hdiff", "box", "cross"):
        kw = {"extent": 2} if shape in ("box", "cross") else {}
        assert rs.synthesize_stencil(num_stages=3, shape=shape, **kw) == \
            ps.synthesize_stencil(num_stages=3, shape=shape, **kw)
    assert rs.jacobi(3, 16, 4) == ps.jacobi(3, 16, 4)


def test_errors_match():
    bad = {"inputs": {"a": {"data": "constant:1", "data_type": "float32"}},
           "outputs": ["b"], "dimensions": [4, 4],
           "program": {"b": {"computation_string": "b = foo(a[j, k])",
                             "data_type": "float32"}}}
    with pytest.raises(port.StencilSyntaxError):
        port.parse_program(bad)
    cyc = {"inputs": {"a": {"data": "constant:1", "data_type": "float32"}},
           "outputs": ["c"], "dimensions": [4, 4],
           "program": {"b": {"computation_string": "b = c[j, k] + a[j, k]",
                             "data_type": "float32"},
                       "c": {"computation_string": "c = b[j, k]",
                             "data_type": "float32"}}}
    with pytest.raises(port.CycleError):
        port.ChainGraph.build(port.parse_program(cyc))
    # bfloat16 parses, as in the JAX package (the port's own dtype,
    # dtypes.BFLOAT16); a name the JAX package refuses is refused
    half = {**bad, "inputs": {"a": {"data": "constant:1",
                                    "data_type": "bfloat16"}},
            "program": {"b": {"computation_string": "b = a[j, k]",
                              "data_type": "bfloat16"}}}
    assert port.parse_program(half).field_dtype("b") == port.dtypes.BFLOAT16
    assert ref.parse_program(half).field_dtype("b").name == "bfloat16"
    eight = {**bad, "inputs": {"a": {"data": "constant:1",
                                     "data_type": "float8"}}}
    for pkg in (port, ref):
        with pytest.raises(ValueError, match="unsupported dtype"):
            pkg.parse_program(eight)


def test_import_scan_covers_the_stream_slice():
    """The scan above reaches the stream lowering's modules (the planner
    copies of linear.py and compose.py, the streamer, its codegen)."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in ("linear", "compose", "stream", "codegen", "build"):
        assert os.path.join("stencilflow_tpu_torch", "backend",
                            mod + ".py") in scanned


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_kernel_strings_match(path):
    """``frontend/export.py``: both kernel-string forms as the JAX
    package's, per kernel (``report --verbose`` prints them)."""
    from stencilflow_tpu.frontend import export as rx
    from stencilflow_tpu_torch.frontend import export as px
    from stencilflow_tpu_torch.frontend.analysis import operation_count
    from stencilflow_tpu.frontend.analysis import \
        operation_count as ref_operation_count
    a, b = ref.parse_program(path), port.parse_program(path)
    rank = len(a.raw_dimensions)
    for k in a.kernels:
        assert rx.kernel_to_string(a.kernels[k], rank) == \
            px.kernel_to_string(b.kernels[k], rank)
        assert rx.kernel_to_relative(a.kernels[k]) == \
            px.kernel_to_relative(b.kernels[k])
        assert ref_operation_count(a.kernels[k]) == \
            operation_count(b.kernels[k])


@pytest.mark.parametrize("seed", range(4))
def test_optimizer_matches(seed):
    """``optimizer.py``: the same buffers and the same placements under
    each strategy as the JAX package's, on fuzz programs."""
    from stencilflow_tpu.optimizer import Optimizer as RefOptimizer
    from stencilflow_tpu_torch.optimizer import Optimizer
    spec = make_random_program(np.random.default_rng(seed), seed)
    ra = RefOptimizer(ref.parse_program(spec))
    pa = Optimizer(port.parse_program(spec))
    total = ra.fast_bytes()
    assert total == pa.fast_bytes()
    for run in (lambda o: o.minimize_fast_mem(total * 2),
                lambda o: o.optimize_to_ratio(0.5),
                lambda o: o.minimize_comm_vol(total // 2, 10 * total + 1)):
        for o in (ra, pa):
            run(o)
        assert ra.placement() == pa.placement()
        assert ra.summary() == pa.summary()
        assert ra.comm_volume() == pa.comm_volume()


def test_import_scan_covers_the_measurement_slice():
    """The scan reaches the report, the bench, the copied optimizer and
    exporter, and the probes."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in ("report.py", "bench.py", "optimizer.py", "frontend/export.py",
                "probes/__init__.py", "probes/copy_floor.py",
                "probes/alu_ceiling.py", "probes/loop_copy.py",
                "probes/dma_overlap.py", "probes/async_ring.py",
                "probes/table_read.py", "probes/stateless_panel.py"):
        assert os.path.join("stencilflow_tpu_torch", mod) in scanned


def test_import_scan_covers_the_rows_slice():
    """The scan reaches the group lowering and the rows rotation."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in ("backend/group.py", "backend/__init__.py",
                "frontend/canonicalize.py"):
        assert os.path.join("stencilflow_tpu_torch", mod) in scanned


def test_import_scan_covers_the_solver_slice():
    """The scan reaches the solver entry points (iterate, grad, solve),
    the exporter and the CLI that drives them, and none of them imports
    jax or the JAX package, at any depth of the module."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in ("iterate.py", "grad.py", "solve.py", "frontend/export.py",
                "cli.py", "__init__.py"):
        rel = os.path.join("stencilflow_tpu_torch", mod)
        assert rel in scanned
        tree = ast.parse(open(os.path.join(ROOT, rel)).read(), rel)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{rel}: {n}"


def test_import_scan_covers_the_simulator_slice():
    """The scan reaches the simulator (sim/) and the driver and CLI that
    run it, and none of them imports jax or the JAX package, at any depth
    of the module."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in ("sim/__init__.py", "sim/bounded_queue.py", "sim/machine.py",
                "sim/native.py", "sim/trace.py", "driver.py", "cli.py"):
        rel = os.path.join("stencilflow_tpu_torch", mod)
        assert rel in scanned
        tree = ast.parse(open(os.path.join(ROOT, rel)).read(), rel)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{rel}: {n}"


def test_import_scan_covers_the_pipeline_slice():
    """The scan reaches the pipeline split (parallel/pipeline.py), the
    mesh and domain modules it runs on, the out-of-core x domain path and
    the cut enumeration (frontend/chain.py), and none of them imports jax
    or the JAX package, at any depth of the module."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in ("parallel/pipeline.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/domain.py", "outofcore.py",
                "frontend/chain.py", "backend/tile_eval.py"):
        rel = os.path.join("stencilflow_tpu_torch", mod)
        assert rel in scanned
        tree = ast.parse(open(os.path.join(ROOT, rel)).read(), rel)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{rel}: {n}"


def test_import_scan_covers_the_autotune_slice():
    """The scan reaches autotune.py and the bench, probes, driver, CLI
    and facade that it runs through, and none of them imports jax or the
    JAX package, at any depth of the module."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in ("autotune.py", "bench.py", "probes/__init__.py",
                "driver.py", "cli.py", "__init__.py"):
        rel = os.path.join("stencilflow_tpu_torch", mod)
        assert rel in scanned
        tree = ast.parse(open(os.path.join(ROOT, rel)).read(), rel)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{rel}: {n}"


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_program_to_json_matches(path):
    """``frontend/export.py program_to_json``: the JAX package's JSON."""
    a, b = ref.parse_program(path), port.parse_program(path)
    want = json.dumps(ref.program_to_json(a), sort_keys=True, default=str)
    assert json.dumps(port.program_to_json(b), sort_keys=True,
                      default=str) == want
    again = port.parse_program(port.program_to_json(b), name=b.name)
    assert json.dumps(port.program_to_json(again), sort_keys=True,
                      default=str) == want


def test_facade_matches_the_reference():
    """Every export of the JAX package's facade, and no other."""
    assert set(port.__all__) == set(ref.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name


def test_import_scan_covers_the_surfaces_slice():
    """The scan reaches the frontends, the plot utilities and the example
    scripts, and none of them imports jax or the JAX package, at any
    depth of the module; matplotlib is imported inside the plot
    functions only (the card's machine has none)."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    mods = ["frontend/canonicalize.py", "frontend/trace.py",
            "frontend/mapnest.py", "frontend/sdfg_import.py",
            "utils/__init__.py", "utils/plot.py", "examples/__init__.py"]
    mods += [f"examples/{n}.py" for n in port_examples.NAMES]
    for mod in mods:
        rel = os.path.join("stencilflow_tpu_torch", mod)
        assert rel in scanned
        tree = ast.parse(open(os.path.join(ROOT, rel)).read(), rel)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{rel}: {n}"
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        assert not any("matplotlib" in ast.dump(n) for n in top), rel
    assert sorted(port_examples.NAMES) == sorted(
        f[:-3] for f in os.listdir(os.path.join(ROOT, "examples"))
        if f.endswith(".py"))


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_chain_graph_dot_matches(path):
    """``utils/plot.py chain_graph_dot``: the JAX package's DOT text."""
    from stencilflow_tpu.utils import chain_graph_dot as ref_dot
    from stencilflow_tpu_torch.utils import chain_graph_dot
    assert chain_graph_dot(port.parse_program(path)) == \
        ref_dot(ref.parse_program(path))
