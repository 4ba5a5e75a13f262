"""The port's Python simulator machine against the JAX package's, on the CPU.

``stencilflow_tpu_torch/sim/`` is a copy of ``stencilflow_tpu/sim/``
(which imports no JAX).  Both packages' Python machines run the same
programs on the same numpy-seeded inputs: cycle counts, FIFO high-water
marks, mean occupancies and per-kernel fire and stall statistics are
equal, outputs are bit-equal (``np.array_equal``, NaN == NaN) to each
other and to the numpy oracle, and the proof discipline's errors have
the same type and message.  The one intended difference: a scalar input
given as a shape-(1,) array is read as the 0-d scalar it stands for
(the original stores a 1-element array).
"""
import json
import os
import warnings

import numpy as np
import pytest

import stencilflow_tpu as ref
import stencilflow_tpu.sim as ref_sim
import stencilflow_tpu_torch as port
import stencilflow_tpu_torch.sim as port_sim
from stencilflow_tpu.sim import machine as ref_machine
from stencilflow_tpu_torch.sim import machine as port_machine
from stencilflow_tpu_torch.synthesize import jacobi, random_program
from test_fuzz import make_mixed_dtype_program

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = [os.path.join(ROOT, "examples", f) for f in
            sorted(os.listdir(os.path.join(ROOT, "examples")))
            if f.endswith(".json")]


def _small(path, size=8):
    spec = json.load(open(path))
    spec["dimensions"] = [min(d, size) for d in spec["dimensions"]]
    return spec


def _both(spec, name, seed):
    """(JAX program, port program, inputs from the port's loader)."""
    a = ref.parse_program(spec, name=name)
    b = port.parse_program(spec, name=name)
    return a, b, port.load_input_arrays(b, seed=seed)


def _same_result(ra, rb):
    assert ra.cycles == rb.cycles
    assert ra.edge_high_water == rb.edge_high_water
    assert ra.edge_mean_occupancy == rb.edge_mean_occupancy
    assert ra.kernel_stats == rb.kernel_stats
    assert list(ra.outputs) == list(rb.outputs)
    for o in ra.outputs:
        assert ra.outputs[o].dtype == rb.outputs[o].dtype
        assert np.array_equal(ra.outputs[o], rb.outputs[o], equal_nan=(
            ra.outputs[o].dtype.kind == "f"))


def _oracle_equal(program, inputs, result):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = port.run_interpreter(program, inputs)
    for o in program.outputs:
        np.testing.assert_array_equal(result.outputs[o],
                                      np.asarray(want[o]))


def _python_machines(spec, name, seed):
    a, b, inputs = _both(spec, name, seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ra = ref_sim.Simulator(a).run(inputs)
        rb = port_sim.Simulator(b).run(inputs)
    _same_result(ra, rb)
    return b, inputs, rb


# -- BoundedQueue: the cases of tests/test_simulator.py, on both packages ----

QUEUES = {"jax": ref_sim, "port": port_sim}


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_queue_import_order_and_peek(pkg):
    q = QUEUES[pkg].BoundedQueue("q", 5, [1, 2, 3])
    assert q.size() == 3
    assert q.peek(0) == 1 and q.peek(2) == 3
    assert q.try_peek_last() == 3
    assert q.dequeue() == 3 and q.dequeue() == 2 and q.dequeue() == 1
    assert q.try_peek_last() is False


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_queue_overflow_underflow(pkg):
    m = QUEUES[pkg]
    q = m.BoundedQueue("q", 2)
    q.enqueue(1)
    q.enqueue(2)
    with pytest.raises(m.QueueOverflow, match="enqueue on full queue"):
        q.enqueue(3)
    assert q.dequeue() == 1
    assert q.dequeue() == 2
    with pytest.raises(m.QueueUnderflow, match="dequeue on empty queue"):
        q.dequeue()
    with pytest.raises(m.QueueUnderflow, match=r"peek\(0\) with size 0"):
        q.peek(0)


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_queue_try_variants(pkg):
    q = QUEUES[pkg].BoundedQueue("q", 1)
    assert q.try_enqueue("a")
    assert not q.try_enqueue("b")
    assert q.try_dequeue() == "a"
    assert q.try_dequeue() is False


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_queue_import_overflow_and_export(pkg):
    m = QUEUES[pkg]
    with pytest.raises(m.QueueOverflow, match="import of 3 items"):
        m.BoundedQueue("q", 2, [1, 2, 3])
    q = m.BoundedQueue("q", 3, [4, 5])
    assert q.export_data() == [5, 4]
    assert not q.is_full() and not q.is_empty() and not q.swap_out


@pytest.mark.parametrize("pkg", sorted(QUEUES))
def test_queue_maxsize_clamped_to_one(pkg):
    assert QUEUES[pkg].BoundedQueue("q", 0).maxsize == 1


def test_queue_errors_are_runtime_errors_in_both():
    for m in QUEUES.values():
        assert issubclass(m.QueueOverflow, RuntimeError)
        assert issubclass(m.QueueUnderflow, RuntimeError)


# -- the machine on the examples and the fuzz corpus -------------------------

@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_python_machine_matches_on_example(path):
    spec = _small(path)
    b, inputs, rb = _python_machines(spec, "ex", seed=2)
    if not any(bc.kind == port.BCKind.SHRINK
               for k in b.kernels.values()
               for bc in k.boundary_conditions.values()):
        _oracle_equal(b, inputs, rb)


@pytest.mark.parametrize("seed", range(10))
def test_python_machine_matches_on_fuzz(seed):
    spec = random_program(np.random.default_rng(seed))
    b, inputs, rb = _python_machines(spec, f"fuzz{seed}", seed)
    _oracle_equal(b, inputs, rb)


@pytest.mark.parametrize("seed", range(4))
def test_python_machine_matches_on_mixed_dtypes(seed):
    """Chains with a dtype per kernel (float32/float64/int32/int16/bool):
    edges carry the producer's dtype in both machines."""
    spec = make_mixed_dtype_program(np.random.default_rng(700 + seed),
                                    nondyadic=seed % 2 == 1,
                                    amplified_consumer=seed >= 2)
    b, inputs, rb = _python_machines(spec, f"mixed{seed}", seed)
    _oracle_equal(b, inputs, rb)


@pytest.mark.parametrize("boundary", ["constant", "copy", "shrink"])
def test_python_machine_matches_on_jacobi(boundary):
    spec = jacobi(3, 8, iterations=2, boundary=boundary)
    b, inputs, rb = _python_machines(spec, f"j_{boundary}", seed=3)
    assert rb.cycles >= b.total_elements


def test_static_schedule_matches():
    """access_windows, fire_schedule and edge_capacities: the same
    numbers in both packages."""
    spec = random_program(np.random.default_rng(11), ndim=3)
    a, b, _ = _both(spec, "sched", 0)
    an, bn = ref.ChainAnalysis.run(a), port.ChainAnalysis.run(b)
    wa = ref_machine.access_windows(a, an)
    wb = port_machine.access_windows(b, bn)
    assert wa == wb
    assert ref_machine.fire_schedule(a, an, wa) == \
        port_machine.fire_schedule(b, bn, wb)
    for slack in (0, 3):
        assert ref_machine.edge_capacities(a, an, slack=slack) == \
            port_machine.edge_capacities(b, bn, slack=slack)


# -- proof discipline: the same errors ---------------------------------------

def _error(fn):
    with pytest.raises(RuntimeError) as exc:
        fn()
    return type(exc.value).__name__, str(exc.value)


def test_undersized_edge_deadlocks_alike():
    spec = jacobi(3, 8, iterations=2)
    a, b, inputs = _both(spec, "undersz", 0)
    errs = []
    for m, p in ((ref_machine, a), (port_machine, b)):
        sim = m.Simulator(p)
        assert sim.edges[("a", "s0")].capacity > 2
        sim.edges[("a", "s0")].capacity = 2   # below the window span
        with pytest.raises(m.DeadlockError) as exc:
            sim.run(inputs)
        errs.append((type(exc.value).__name__, str(exc.value)))
    assert errs[0] == errs[1]
    assert errs[1][0] == "DeadlockError"
    assert errs[1][1].startswith("simulation stalled at cycle")


def _corrupt_windows(real_fn):
    """Raise the (a, s0) retention floor by one: the machine releases an
    element the kernel still reads — a seeded staleness bug."""
    def fake(program, analysis):
        w = dict(real_fn(program, analysis))
        lo, hi = w[("a", "s0")]
        w[("a", "s0")] = (lo + 1, hi)
        return w
    return fake


def test_stale_read_raises_alike(monkeypatch):
    spec = jacobi(3, 8, iterations=2)
    a, b, inputs = _both(spec, "stale", 0)
    for m in (ref_machine, port_machine):
        monkeypatch.setattr(m, "access_windows",
                            _corrupt_windows(m.access_windows))
    want = _error(lambda: ref_sim.Simulator(a).run(inputs))
    got = _error(lambda: port_sim.Simulator(b).run(inputs))
    assert got == want
    assert "stale/underflow read on edge a->s0" in got[1]


def test_edge_peek_guard_alike():
    msgs = []
    for m in (ref_machine, port_machine):
        e = m._Edge("a", "b", capacity=4)
        for v in range(4):
            assert e.push(float(v))
        assert not e.push(4.0) and e.high_water == 4
        e.release_to(2)
        for idx in (1, 4):
            with pytest.raises(m.SimulationError) as exc:
                e.peek(idx)
            msgs.append(str(exc.value))
    assert msgs[:2] == msgs[2:]


def test_trace_csv_matches(tmp_path):
    """The per-cycle CSV trace: byte-equal between the packages."""
    spec = jacobi(3, 6, iterations=2)
    a, b, inputs = _both(spec, "trace", 1)
    ra = ref_sim.Simulator(a).run(inputs, trace=str(tmp_path / "a.csv"))
    rb = port_sim.simulate(b, inputs, trace=str(tmp_path / "b.csv"))
    _same_result(ra, rb)
    assert (tmp_path / "a.csv").read_bytes() == \
        (tmp_path / "b.csv").read_bytes()


# -- the one intended difference: shape-(1,) scalars -------------------------

SCALAR_SPEC = {
    "inputs": {"a": {"data": "random:0,1", "data_type": "float64"},
               "c": {"data": 2.5, "data_type": "float64",
                     "input_dims": []}},
    "outputs": ["b"], "dimensions": [8, 8],
    "program": {"b": {
        "computation_string": "b = c * a[j,k] + a[j-1,k]",
        "boundary_conditions": {"a": {"type": "constant", "value": 0.0}},
        "data_type": "float64"}}}


def test_shape1_scalar_reads_as_0d_scalar():
    """The port's machine stores a shape-(1,) scalar input as the 0-d
    scalar it stands for, so its outputs equal the 0-d run's and the JAX
    package's 0-d run's; the original stores a 1-element array there."""
    a, b, inputs = _both(SCALAR_SPEC, "sc1", 8)
    zero_d = dict(inputs, c=np.float64(2.5))
    one_d = dict(inputs, c=np.array([2.5]))
    want = ref_sim.Simulator(a).run(zero_d)
    got0 = port_sim.Simulator(b).run(zero_d)
    sim = port_sim.Simulator(b)
    got1 = sim.run(one_d)
    _same_result(want, got0)
    _same_result(want, got1)
    assert np.ndim(sim.scalars["c"]) == 0
    _oracle_equal(b, zero_d, got1)
