"""The port's multi-host launch against the JAX package's, on the CPU.

Mirrors ``tests/test_multihost.py``: two real OS processes of the port's
CLI (``run-distributed --coordinator``), each holding two virtual CPU
positions of a 4-position global mesh (``--devices 4
--force-host-devices``), joined over gloo on a free 127.0.0.1 port.  Each
runs the same program (domain decomposition, with and without the
comm/compute overlap, or the pipeline split) and checks the output
shards it holds against the oracle, printing the JAX package's lines.
Each also saves the shards it verified; here they are held to the JAX
package's oracle on the same seed (bit for bit) and to its sharded
engine, or its pipeline, on its virtual CPU devices.

Two spawned processes also run the halo exchange alone on a 2 x 2 mesh
split between them along x or along y: each rank's widened tiles equal
the single-process exchange's element for element, and the bytes a rank
receives are the remote faces of the mesh-scaling model's slabs.  Every
misdirected or incomplete flag set exits 2 before any rendezvous, with
no peer running.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _domain_program():
    return {
        "inputs": {"a": {"data": "random:-1,1", "data_type": "float32"}},
        "outputs": ["s1"],
        "dimensions": [8, 16, 16],
        "program": {
            "s0": {"computation_string":
                   "s0 = 0.25 * (a[i,j-1,k] + a[i,j+1,k] + a[i,j,k-1]"
                   " + a[i,j,k+1])",
                   "boundary_conditions": {
                       "a": {"type": "constant", "value": 1.0}},
                   "data_type": "float32"},
            "s1": {"computation_string":
                   "s1 = s0[i,j,k] + 0.5 * (s0[i-1,j,k] + s0[i+1,j,k])",
                   "boundary_conditions": {
                       "s0": {"type": "constant", "value": 0.0}},
                   "data_type": "float32"},
        },
    }


def _pipeline_program():
    return {
        "inputs": {"a": {"data": "random:-1,1", "data_type": "float32"}},
        "outputs": ["s3"],
        "dimensions": [8, 16, 16],
        "program": {
            f"s{i}": {
                "computation_string":
                    f"s{i} = 0.25 * ({p}[i,j-1,k] + {p}[i,j+1,k] "
                    f"+ {p}[i-1,j,k-1] + {p}[i,j,k+1])",
                "boundary_conditions": {
                    p: {"type": "constant", "value": 1.0}},
                "data_type": "float32"}
            for i, p in enumerate(["a", "s0", "s1", "s2"])
        },
    }


def _run_pair(cmds):
    """Both processes at once; on a timeout both are killed."""
    procs = [subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _cli_saving_shards(argv, out: str) -> int:
    """One process of the port's CLI (``cli.main(argv)``) that also saves
    the output shards it verifies to ``out`` (npz, a key
    ``<output>|<start>:<stop>,...`` a shard), for the test process to
    hold against the JAX package."""
    from stencilflow_tpu_torch import cli
    from stencilflow_tpu_torch.dtypes import to_numpy
    verify = cli._verify_local_shards

    def key(o, arr, c):
        idx = tuple(arr.block_slices(c))
        idx += (slice(None),) * (len(arr.shape) - len(idx))
        return o + "|" + ",".join("%d:%d" % s.indices(n)[:2]
                                  for s, n in zip(idx, arr.shape))

    def save_then_verify(program, inputs, res, host):
        np.savez(out, **{key(o, arr, c): to_numpy(t)
                         for o, arr in res.items()
                         for c, t in arr.shards.items()})
        return verify(program, inputs, res, host)
    cli._verify_local_shards = save_then_verify
    return cli.main(argv)


def _launch(tmp_path, prog, extra):
    """Both hosts of ``run-distributed --coordinator`` on the CPU; each
    saves the shards it verified to ``tmp_path / shards{host}.npz``."""
    path = tmp_path / "mh.json"
    path.write_text(json.dumps(prog))
    port = _free_port()
    code = ("import sys; sys.path.insert(0, {tests!r}); "
            "import test_torch_multihost as m; "
            "sys.exit(m._cli_saving_shards({argv!r}, {out!r}))")
    return _run_pair([
        [sys.executable, "-c", code.format(
            tests=os.path.dirname(os.path.abspath(__file__)),
            out=str(tmp_path / f"shards{host}.npz"), argv=[
                "run-distributed", str(path), "--devices", "4",
                "--force-host-devices", "--coordinator",
                f"127.0.0.1:{port}", "--num-hosts", "2", "--host-id",
                str(host), "--compare-to-reference"] + extra)]
        for host in range(2)])


def _held_shards(tmp_path):
    """[(output, block slices, array)] of both hosts' saved shards."""
    got = []
    for host in range(2):
        with np.load(tmp_path / f"shards{host}.npz") as z:
            for key in z.files:
                o, idx = key.split("|")
                got.append((o, tuple(slice(*map(int, r.split(":")))
                                     for r in idx.split(",")), z[key]))
    return got


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _assert_shards_equal_jax(tmp_path, spec, run_jax=None):
    """Every shard both hosts hold equals the JAX package's oracle on the
    same seed's inputs bit for bit, and (``run_jax``: the JAX package's
    sharded engine on its virtual CPU devices) that engine's block within
    VERIFY_RTOL; together the shards cover every output."""
    import stencilflow_tpu as ref
    from stencilflow_tpu_torch.config import VERIFY_RTOL
    a = ref.parse_program(spec)
    inputs = ref.load_input_arrays(a, seed=0)
    oracle = {o: np.asarray(v).reshape(a.raw_dimensions)
              for o, v in ref.run_interpreter(a, inputs).items()}
    engine = run_jax(a, inputs) if run_jax else {}
    covered = {o: np.zeros(a.raw_dimensions, bool) for o in a.outputs}
    for o, idx, got in _held_shards(tmp_path):
        np.testing.assert_array_equal(_bits(got), _bits(oracle[o][idx]))
        if o in engine:
            want = engine[o].reshape(a.raw_dimensions)[idx]
            assert np.allclose(got, want, rtol=VERIFY_RTOL,
                               atol=VERIFY_RTOL), (o, idx)
        covered[o][idx] = True
    assert all(c.all() for c in covered.values())


def _jax_domain(axes, overlap):
    def run(a, inputs):
        import jax
        from jax.sharding import Mesh as JaxMesh
        from stencilflow_tpu.parallel.domain import run_sharded_chain
        mesh = JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2),
                       ("x", "y"))
        return run_sharded_chain(a, mesh, axes, inputs,
                                 comm_overlap=overlap)
    return run


def _jax_pipeline(num_chunks):
    def run(a, inputs):
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh as JaxMesh
        from jax.sharding import NamedSharding
        from stencilflow_tpu.parallel import pipeline as rp
        mesh = JaxMesh(np.array(jax.devices()[:4]), ("p",))
        fn, _plan = rp.compile_pipeline_split(a, mesh, "p",
                                              num_chunks=num_chunks)
        specs = rp.compile_pipeline_split.last_config["in_specs"]
        jin = {}
        for nm, v in inputs.items():
            spec = a.inputs[nm]
            arr = jnp.asarray(v)
            if not spec.is_scalar:
                arr = arr.reshape(tuple(a.dimensions[d] for d in range(3)
                                        if spec.dim_mask[d]))
            jin[nm] = jax.device_put(arr, NamedSharding(mesh, specs[nm]))
        return {k: np.asarray(v) for k, v in fn(jin).items()}
    return run


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("dim_axes", ["none,x,y", "x,y,none"])
def test_two_process_domain_decomposition(tmp_path, dim_axes, overlap):
    extra = ["--parallel-mode", "domain", "--dim-axes", dim_axes]
    if overlap:
        extra.append("--comm-overlap")
    for host, (rc, out) in enumerate(_launch(tmp_path, _domain_program(),
                                             extra)):
        assert rc == 0, f"host {host} failed:\n{out}"
        assert f"host {host}: verified local shards: OK" in out, out
        assert "4 global devices" in out, out
        assert (f"host {host}: ran domain over 4 global devices (mesh "
                "{'x': 2, 'y': 2}, 2 local, exchange over gloo, "
                "host-staged)") in out, out
    axes = tuple(None if a == "none" else a for a in dim_axes.split(","))
    _assert_shards_equal_jax(tmp_path, _domain_program(),
                             _jax_domain(axes, overlap))


def test_two_process_bf16_program(tmp_path):
    """A program typed bfloat16: its 2-byte slabs cross processes as raw
    bytes, and each host's shards equal the oracle's."""
    prog = _domain_program()
    prog["inputs"]["a"]["data_type"] = "bfloat16"
    for stage in prog["program"].values():
        stage["data_type"] = "bfloat16"
    for host, (rc, out) in enumerate(_launch(
            tmp_path, prog, ["--dim-axes", "x,y,none"])):
        assert rc == 0, f"host {host} failed:\n{out}"
        assert f"host {host}: verified local shards: OK" in out, out
    _assert_shards_equal_jax(tmp_path, prog)


@pytest.mark.parametrize("chunks,io", [(None, "sharded"), (2, "replicated")])
def test_two_process_pipeline_split(tmp_path, chunks, io):
    """The 4-stage chain over the 4-position ``("p",)`` mesh, two
    positions a process: sharded io (hops of the feed, carry and return
    rings cross processes) and replicated io (``--num-chunks 2``: the
    carry hops and the outputs sent from the last position)."""
    extra = ["--parallel-mode", "pipeline"]
    if chunks:
        extra += ["--num-chunks", str(chunks)]
    for host, (rc, out) in enumerate(_launch(tmp_path, _pipeline_program(),
                                             extra)):
        assert rc == 0, f"host {host} failed:\n{out}"
        assert f"host {host}: verified local shards: OK" in out, out
        assert "ran pipeline over 4 global devices" in out, out
        assert f"io={io}, 2 local" in out, out
    _assert_shards_equal_jax(tmp_path, _pipeline_program(),
                             _jax_pipeline(chunks))


def _expected_received(plan, program, mesh) -> int:
    """The bytes this rank receives: for each of its positions, each
    sharded dim and face whose neighbour another rank holds, the slab of
    every input spanning that dim (dims widened before it whole, the rest
    at their core)."""
    total = 0
    for c in mesh.local_coords():
        for name, spec in program.inputs.items():
            if spec.is_scalar:
                continue
            dims = [d for d in range(3) if spec.dim_mask[d]]
            isz = np.dtype(spec.dtype).itemsize
            for pos, d in enumerate(dims):
                h = plan.halo[d]
                if not h:
                    continue
                ax = mesh.axis_names.index(plan.dim_axes[d])
                slab = h * int(np.prod([
                    plan.block[o] + (2 * plan.halo[o] if p < pos else 0)
                    for p, o in enumerate(dims) if o != d]))
                for nb in (c[ax] - 1, c[ax] + 1):
                    o = c[:ax] + (nb,) + c[ax + 1:]
                    if 0 <= nb < mesh.devices.shape[ax] and \
                            not mesh.is_local(o):
                        total += slab * isz
    return total


def _exchange_worker(port: int, rank: int, dim_axes: str, out: str) -> None:
    """One rank of the exchange check: the tiles ``_exchange_halo`` widens
    for this rank's positions, the single-process tiles of the same
    positions, the bytes received and the model's bytes, saved to
    ``out``."""
    import torch.distributed as dist

    import stencilflow_tpu_torch as port_pkg
    from stencilflow_tpu_torch.parallel import transport
    from stencilflow_tpu_torch.parallel.domain import (compile_sharded_chain,
                                                       place_global_inputs)
    from stencilflow_tpu_torch.parallel.mesh import (make_host_mesh,
                                                     make_mesh)
    from stencilflow_tpu_torch.report import Report
    from stencilflow_tpu_torch.synthesize import synthesize_stencil
    axes = tuple(None if a == "none" else a for a in dim_axes.split(","))
    p = port_pkg.parse_program(synthesize_stencil(
        num_stages=2, dimensions=(8, 16, 24), shape="hotspot"), name="xh")
    inputs = port_pkg.load_input_arrays(p, seed=5)
    transport.init_hosts(f"127.0.0.1:{port}", 2, rank)
    try:
        mesh = make_host_mesh(["cpu"] * 2, (2, 2), ("x", "y"), rank, 2)
        fn, plan = compile_sharded_chain(p, mesh, axes)
        placed = place_global_inputs(p, plan, inputs)
        transport.stats["bytes_received"] = 0
        got = fn.exchange(placed)
        received = transport.stats["bytes_received"]
        one = make_mesh(["cpu"], (2, 2), ("x", "y"))
        fn1, plan1 = compile_sharded_chain(p, one, axes)
        want = fn1.exchange(place_global_inputs(p, plan1, inputs))
        model = Report.build(p).mesh_scaling({"x": 2, "y": 2}, axes)
        res = {"coords": [list(c) for c in got],
               "equal": all(
                   (got[c][n] == want[c][n]).all().item()
                   if not p.inputs[n].is_scalar else True
                   for c in got for n in got[c]),
               "shapes_equal": all(
                   tuple(got[c][n].shape) == tuple(want[c][n].shape)
                   for c in got for n in got[c]
                   if not p.inputs[n].is_scalar),
               "received": received,
               "expected": _expected_received(plan, p, mesh),
               "model": model["ici_bytes_per_device"],
               "both_faces": sum(
                   (want[c][n].numel() - placed[n].shards[c].numel())
                   * want[c][n].element_size()
                   for n in p.inputs if not p.inputs[n].is_scalar
                   for c in list(got)[:1])}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


@pytest.mark.parametrize("dim_axes", ["none,x,y", "none,y,x"])
def test_exchange_across_processes_equals_one_process(tmp_path, dim_axes):
    """The 2 x 2 mesh split between two ranks along x: with j over x
    (``none,x,y``) the rank boundary cuts j, with ``none,y,x`` it cuts k
    (whose slabs span the widened j).  Every widened tile equals the
    single-process exchange's; a rank receives exactly the remote faces,
    and one position's widening (both faces of every sharded dim) is the
    model's ``ici_bytes_per_device``."""
    port = _free_port()
    code = ("import sys; sys.path.insert(0, {tests!r}); "
            "import test_torch_multihost as m; "
            "m._exchange_worker({port}, {rank}, {axes!r}, {out!r})")
    outs = [str(tmp_path / f"r{r}.json") for r in range(2)]
    got = _run_pair([
        [sys.executable, "-c", code.format(
            tests=os.path.dirname(os.path.abspath(__file__)), port=port,
            rank=r, axes=dim_axes, out=outs[r])] for r in range(2)])
    for r, (rc, out) in enumerate(got):
        assert rc == 0, f"rank {r}:\n{out}"
    res = [json.load(open(o)) for o in outs]
    assert sorted(map(tuple, res[0]["coords"] + res[1]["coords"])) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in res:
        assert r["shapes_equal"] and r["equal"], r
        assert r["received"] == r["expected"] > 0, r
        assert r["both_faces"] == r["model"], r


MISDIRECTED = [
    (["--num-hosts", "2"], "requires --num-hosts and --host-id"),
    (["--host-id", "0"], "requires --num-hosts and --host-id"),
    (["--num-hosts", "2", "--host-id", "2"], "not a rank"),
    (["--num-hosts", "2", "--host-id", "0", "--split-at", "s0"],
     "pipeline mode only"),
    (["--num-hosts", "2", "--host-id", "0", "--parallel-mode", "pipeline",
      "--dim-axes", "x,none,none"], "domain mode only"),
    (["--num-hosts", "2", "--host-id", "1", "--parallel-mode", "pipeline",
      "--comm-overlap"], "domain mode only"),
    (["--num-hosts", "2", "--host-id", "0", "--devices", "3"],
     "not divisible by --num-hosts"),
    (["--num-hosts", "2", "--host-id", "0", "--dim-axes", "x,q,none"],
     "unknown mesh axis"),
    (["--num-hosts", "2", "--host-id", "0", "--dim-axes", "x,y"],
     "3 entries"),
]


@pytest.mark.parametrize("extra,msg", MISDIRECTED)
def test_misdirected_flags_rejected_before_rendezvous(tmp_path, capsys,
                                                      monkeypatch, extra,
                                                      msg):
    """Each exits 2 with its message and never reaches the rendezvous (no
    peer runs: a rendezvous would wait for one)."""
    from stencilflow_tpu_torch.cli import main
    from stencilflow_tpu_torch.parallel import transport

    def no_rendezvous(*_a, **_k):
        raise AssertionError("reached the rendezvous")
    monkeypatch.setattr(transport, "init_hosts", no_rendezvous)
    path = tmp_path / "p.json"
    path.write_text(json.dumps(_pipeline_program()))
    argv = ["run-distributed", str(path), "--devices", "4",
            "--force-host-devices", "--coordinator", "127.0.0.1:1"] + extra
    assert main(argv) == 2
    assert msg in capsys.readouterr().err


def test_pipeline_domain_refused_with_coordinator(tmp_path, capsys,
                                                  monkeypatch):
    """An intended divergence: the JAX package's multi-host pipeline
    builds a bare ``("p",)`` mesh and drops ``--pipeline-domain`` without
    a word; the port refuses the pair (rc 2) before any rendezvous."""
    from stencilflow_tpu.cli import build_parser as ref_parser
    from stencilflow_tpu_torch.cli import main
    from stencilflow_tpu_torch.parallel import transport
    monkeypatch.setattr(transport, "init_hosts", lambda *a, **k: 1 / 0)
    path = tmp_path / "p.json"
    path.write_text(json.dumps(_pipeline_program()))
    argv = ["run-distributed", str(path), "--devices", "4",
            "--force-host-devices", "--parallel-mode", "pipeline",
            "--pipeline-domain", "j=2", "--coordinator", "127.0.0.1:1",
            "--num-hosts", "2", "--host-id", "0"]
    ref_parser().parse_args(argv)   # the JAX package takes the flags
    assert main(argv) == 2
    assert "--pipeline-domain does not run with --coordinator" in \
        capsys.readouterr().err


def test_too_few_local_devices(tmp_path, capsys, monkeypatch):
    """Each process needs ``--devices // --num-hosts`` local CUDA
    devices: one card takes ``--devices 2 --num-hosts 2`` (one position a
    process, both on cuda:0), not ``--devices 4``."""
    import torch

    from stencilflow_tpu_torch.cli import main
    from stencilflow_tpu_torch.parallel import transport
    monkeypatch.setattr(transport, "init_hosts", lambda *a, **k: 1 / 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    path = tmp_path / "p.json"
    path.write_text(json.dumps(_domain_program()))
    assert main(["run-distributed", str(path), "--devices", "4",
                 "--coordinator", "127.0.0.1:1", "--num-hosts", "2",
                 "--host-id", "0"]) == 2
    assert "only 1 devices available" in capsys.readouterr().err


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_mesh_shape_2d_equals_the_jax_cli(n):
    """The global ('x', 'y') mesh a multi-host launch builds has the JAX
    CLI's near-square shape (``cli._make_mesh_2d``) on its CPU devices."""
    import jax
    from stencilflow_tpu.cli import _make_mesh_2d
    from stencilflow_tpu_torch.parallel.mesh import mesh_shape_2d
    want = _make_mesh_2d(jax.devices()[:n], n)
    assert mesh_shape_2d(n) == tuple(want.devices.shape)


def test_host_mesh_holds_its_own_positions():
    """``make_host_mesh``: rank r holds the r-th run of positions in
    row-major order; ``place`` places those only, and ``gather`` raises
    rather than gather across processes."""
    import torch

    from stencilflow_tpu_torch.parallel.mesh import (ShardedArray,
                                                     make_host_mesh)
    mesh = make_host_mesh(["cpu"] * 2, (2, 2), ("x", "y"), 1, 2)
    assert mesh.distributed and mesh.local_coords() == [(1, 0), (1, 1)]
    assert [mesh.owner(c) for c in mesh.coords()] == [0, 0, 1, 1]
    v = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    arr = ShardedArray.place(mesh, ("x", "y"), v)
    assert sorted(arr.shards) == [(1, 0), (1, 1)]
    for c, t in arr.shards.items():
        assert torch.equal(t, v[arr.block_slices(c)])
    with pytest.raises(ValueError, match="spans processes"):
        arr.gather()


def test_timing_worker_two_processes(tmp_path):
    """``chip_smoke._timed_host`` (the card's timed leg) on the CPU: each
    rank prints its JSON line, its received bytes the remote face of the
    slabs, beside the model's bytes."""
    path = tmp_path / "mh.json"
    path.write_text(json.dumps(_domain_program()))
    port = _free_port()
    got = _run_pair([
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke._timed_host("
         f"{str(path)!r}, '127.0.0.1:{port}', {h}, device='cpu'))"]
        for h in range(2)])
    for h, (rc, out) in enumerate(got):
        assert rc == 0, out
        row = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("{")][-1])
        assert row["host"] == h and row["local"] == 1
        assert row["mesh"] == {"x": 1, "y": 2}
        assert row["call_ms"] > 0 and row["exchange_ms"] > 0
        # the (1, 2) mesh cuts k (h = 1) between the ranks: each receives
        # one 8 x 16 x 1 float32 slab a call; the model counts both faces
        assert row["bytes_received"] == 8 * 16 * 1 * 4
        assert row["model_ici_bytes_per_device"] == 2 * 8 * 16 * 1 * 4
