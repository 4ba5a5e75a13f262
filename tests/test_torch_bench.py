"""The port's bench (``python -m stencilflow_tpu_torch.bench``) on the CPU.

Each workload is the program the JAX package's ``bench.py`` builds, from
the same synthesizer; ``--device cpu`` prints one JSON line with the
reference's keys, no device metric (``vs_baseline`` null, no bounds), and
``--device cuda`` without a card raises.
"""
import json

import pytest
import torch

import stencilflow_tpu as ref
from stencilflow_tpu import synthesize as ref_synth
from stencilflow_tpu_torch import bench


def _run(capsys, argv):
    assert bench.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.mark.parametrize("workload", bench.WORKLOADS)
def test_cpu_prints_one_json_line(workload, capsys):
    rec = _run(capsys, ["--workload", workload, "--device", "cpu"])
    # bench.py's keys on a CPU run, and the device beside them
    assert {"metric", "value", "unit", "vs_baseline"} <= set(rec)
    assert rec["unit"] == "GCell/s" and rec["value"] >= 0
    assert rec["vs_baseline"] is None and "bounds" not in rec
    assert rec["device"] == {"name": "cpu", "power_limit_w": None}
    size = bench.CPU_SIZE[workload]
    tag = workload if workload.endswith("2d") else workload + "3d"
    rank = 2 if workload == "jacobi2d" else 3
    assert rec["metric"] == f"{tag}_{size}^{rank}_8itr_dense_cpu"


def _reference_program(workload, size, iters):
    """The program the JAX package's bench.py builds for ``workload``."""
    if workload == "jacobi2d":
        return ref.parse_program(ref_synth.jacobi(2, size, iterations=iters))
    if workload == "jacobi":
        return ref.parse_program(ref_synth.jacobi(3, size, iterations=iters))
    return ref.parse_program(ref_synth.synthesize_stencil(
        num_stages=iters, dimensions=(size,) * 3, shape=workload,
        extent=2 if workload == "box" else 1))


@pytest.mark.parametrize("workload", bench.WORKLOADS)
def test_workloads_are_the_reference_programs(workload):
    size = {"jacobi2d": 24}.get(workload, 12)
    p = bench.build_program(workload, size, 3)
    q = _reference_program(workload, size, 3)
    assert p.dimensions == q.dimensions and list(p.inputs) == list(q.inputs)
    assert p.outputs == q.outputs
    for k in q.kernels:
        assert repr(p.kernels[k].statements) == repr(q.kernels[k].statements)


def test_card_sizes_and_loop_lengths():
    """PERF.md's H100 sizes; bench.py's loop lengths on the card."""
    assert bench.CARD_SIZE == {"jacobi": 512, "jacobi2d": 8192, "box": 256,
                               "hotspot": 256, "hdiff": 256}
    assert bench.loop_lengths(512 ** 3, True) == (3, 15, 5)
    assert bench.loop_lengths(256 ** 3, True) == (24, 120, 5)
    assert bench.loop_lengths(8192 ** 2, True) == (6, 30, 5)
    assert bench.loop_lengths(16 ** 3, False) == (1, 5, 3)


def test_sessions_log_and_backend_names(tmp_path, capsys):
    log = tmp_path / "log.jsonl"
    rec = _run(capsys, ["--workload", "jacobi2d", "--size", "16",
                        "--iters", "2", "--device", "cpu", "--sessions",
                        "2", "--backend", "xla", "--append-log", str(log)])
    assert rec["metric"] == "jacobi2d_16^2_2itr_dense_cpu"
    assert rec["sessions"] == 2 and len(rec["session_values"]) == 2
    assert rec["spread_pct"] >= 0
    logged = json.loads(log.read_text().strip())
    assert logged["metric"] == rec["metric"] and "ts" in logged
    rec = _run(capsys, ["--workload", "jacobi", "--size", "12", "--iters",
                        "2", "--device", "cpu", "--backend", "pallas"])
    assert rec["metric"] == "jacobi3d_12^3_2itr_tile_cpu"


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main(["--workload", "jacobi", "--size", "8"])
