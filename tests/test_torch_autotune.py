"""The port's measured lowering selection (``autotune.py``) against the
JAX package's, on the CPU.

Programs: jacobi3d 16^3 x 3, jacobi2d 32^2 x 4 and a box chain of extent
2 at 12^3 x 2 (wide affine stages: a banded stream candidate).  The
port's labels and ``NOT_PORTED_LABELS`` cover the JAX package's
``_builders`` exactly; every candidate that ``autotune(device="cpu")``
times (each through its plain version) equals the numpy oracle (bit for
bit per cell, within MXU_VERIFY_RTOL where the stream plan has banded
stages), and the candidates that both packages build equal the JAX
package's ``build_from_label(..., interpret=True)`` within VERIFY_RTOL on
the same seeded inputs.  Timings on the CPU are no device metric: these
tests check the mechanism (scope skips, failures that raise, the cache).
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import stencilflow_tpu_torch as sft
from stencilflow_tpu_torch import autotune as at
from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL, VERIFY_RTOL
from stencilflow_tpu_torch.data import arrays_are_equal
from stencilflow_tpu_torch.driver import run_program
from stencilflow_tpu_torch.synthesize import jacobi, synthesize_stencil

PROGRAMS = {
    "jacobi3d": lambda: jacobi(3, 16, iterations=3),
    "jacobi2d": lambda: jacobi(2, 32, iterations=4),
    "box-r2": lambda: synthesize_stencil(num_stages=2, dimensions=(12,) * 3,
                                         shape="box", extent=2),
}
JAX_LABELS = ("stream", "panel:B=auto", "group:g=2", "pallas", "xla")


def _port(name):
    return sft.parse_program(PROGRAMS[name](), name=name)


def _ref_builders(name, **kw):
    import stencilflow_tpu as ref
    from stencilflow_tpu.autotune import _builders
    from stencilflow_tpu.frontend.analysis import ChainAnalysis
    p = ref.parse_program(PROGRAMS[name](), name=name)
    return _builders(p, ChainAnalysis.run(p), True, **kw)


def _port_builders(name, **kw):
    p = _port(name)
    return at._builders(p, sft.ChainAnalysis.run(p), "cpu", **kw)


@functools.lru_cache(maxsize=None)
def _tuned(name):
    """(program, AutotuneResult) of the default labels on the CPU."""
    p = _port(name)
    return p, at.autotune(p, device="cpu", trials=1)


def _tensors(p, inputs):
    return {k: v if p.inputs[k].is_scalar else torch.as_tensor(v)
            for k, v in inputs.items()}


def _banded(fn) -> bool:
    return bool(getattr(fn, "last_config", {}).get("mxu_stages"))


# -- (a) labels ---------------------------------------------------------------
@pytest.mark.parametrize("mxu", ["auto", "off"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_labels_cover_the_reference_builders(name, mxu):
    """Every reference label is built by the port or named in
    NOT_PORTED_LABELS, never both, and the port keeps its order."""
    ref = list(_ref_builders(name, mxu=mxu))
    port = list(_port_builders(name, mxu=mxu))
    not_ported = set(at.NOT_PORTED_LABELS)
    assert set(port) | (not_ported & set(ref)) == set(ref)
    assert not set(port) & not_ported
    assert port == [l for l in ref if l in port]


def test_not_ported_labels_are_reference_labels_with_reasons():
    seen = set()
    for name in PROGRAMS:
        seen |= set(_ref_builders(name))
    assert set(at.NOT_PORTED_LABELS) <= seen
    assert all(why.strip() for why in at.NOT_PORTED_LABELS.values())


def test_default_labels_are_the_reference_less_not_ported():
    from stencilflow_tpu import autotune as ref
    assert at.DEFAULT_LABELS == [l for l in ref.DEFAULT_LABELS
                                 if l not in at.NOT_PORTED_LABELS]
    assert at.REDUCED_PRECISION_LABELS == ref.REDUCED_PRECISION_LABELS
    assert not set(at.REDUCED_PRECISION_LABELS) & set(at.NOT_PORTED_LABELS)


def test_facade_exports_the_compile_entry_point_only():
    import stencilflow_tpu_torch.autotune as module
    assert sft.compile_chain_autotuned is at.compile_chain_autotuned
    assert sft.autotune is module


# -- (b) every candidate against the oracle and the JAX package --------------
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_autotune_skips_only_out_of_scope_candidates(name):
    p, res = _tuned(name)
    assert res.label in res.timings and res.fn is not None
    assert all(np.isfinite(t) and t > 0 for t in res.timings.values())
    assert res.seconds == min(res.timings.values())
    assert set(res.timings) | set(res.skipped) == {
        l for l in at.DEFAULT_LABELS if l in _port_builders(name)}
    for label, why in res.skipped.items():
        with pytest.raises((ValueError, NotImplementedError)) as info:
            at.build_from_label(p, label, device="cpu")
        assert str(info.value) == why


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_every_timed_candidate_equals_the_oracle(name):
    p, res = _tuned(name)
    inputs = sft.load_input_arrays(p, seed=0)
    oracle = sft.run_interpreter(p, inputs)
    for label in res.timings:
        fn = at.build_from_label(p, label, device="cpu")
        got = fn(_tensors(p, inputs))
        for o in p.outputs:
            if _banded(fn):
                assert arrays_are_equal(oracle[o], got[o].numpy(),
                                        MXU_VERIFY_RTOL), (label, o)
            else:
                np.testing.assert_array_equal(got[o].numpy(), oracle[o],
                                              err_msg=label)
    winner = res.fn(_tensors(p, inputs))
    for o in p.outputs:
        assert arrays_are_equal(oracle[o], winner[o].numpy(),
                                MXU_VERIFY_RTOL)


@pytest.mark.parametrize("label", JAX_LABELS)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_candidate_equals_the_jax_package(name, label):
    import jax.numpy as jnp
    import stencilflow_tpu as ref
    from stencilflow_tpu.autotune import build_from_label
    rp = ref.parse_program(PROGRAMS[name](), name=name)
    p = _port(name)
    inputs = sft.load_input_arrays(p, seed=0)
    want = build_from_label(rp, label, interpret=True)(
        {k: jnp.asarray(v) for k, v in inputs.items()})
    got = at.build_from_label(p, label, device="cpu")(_tensors(p, inputs))
    for o in p.outputs:
        assert arrays_are_equal(np.asarray(want[o]), got[o].numpy(),
                                VERIFY_RTOL), (label, o)


# -- (c) labels round-trip ----------------------------------------------------
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_build_from_label_round_trips(name):
    p, res = _tuned(name)
    inputs = _tensors(p, sft.load_input_arrays(p, seed=0))
    rebuilt = at.build_from_label(p, res.label, device="cpu")(inputs)
    first = res.fn(inputs)
    for o in p.outputs:
        assert torch.equal(rebuilt[o], first[o])
    with pytest.raises(KeyError, match="nonsense"):
        at.build_from_label(p, "nonsense", device="cpu")


@pytest.mark.parametrize("label", sorted(at.NOT_PORTED_LABELS))
def test_not_ported_label_raises_naming_its_reason(label):
    p = _port("jacobi2d")
    with pytest.raises(NotImplementedError) as info:
        at.build_from_label(p, label, device="cpu")
    assert at.NOT_PORTED_LABELS[label] in str(info.value)
    with pytest.raises(NotImplementedError):
        at.autotune(p, labels=[label], device="cpu", trials=1)


# -- (d) the cache ------------------------------------------------------------
def _with_data(p, fill):
    inputs = {n: dataclasses.replace(s, data=np.full(
        s.shape(p.dimensions), fill, np.dtype(s.dtype)))
        for n, s in p.inputs.items()}
    return dataclasses.replace(p, inputs=inputs)


def test_cache_key_is_structural(monkeypatch):
    p = _port("jacobi3d")
    key = at.cache_key(p, "cpu")
    assert key == at.cache_key(p, "cpu")
    assert key == at.cache_key(
        sft.parse_program(PROGRAMS["jacobi3d"](), name="renamed"), "cpu")
    assert at.cache_key(_with_data(p, 1.0), "cpu") == at.cache_key(
        _with_data(p, 2.5), "cpu")
    assert key != at.cache_key(sft.parse_program(jacobi(3, 12,
                                                        iterations=3)), "cpu")
    for setting in (dict(mxu="off"), dict(mxu_precision="exact"),
                    dict(spill="off"), dict(allow_reduced_precision=True)):
        assert at.cache_key(p, "cpu", **setting) != key, setting
    names = iter(["NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB"])
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: next(names))
    on_h100, on_a100 = at.cache_key(p, "cuda"), at.cache_key(p, "cuda")
    assert len({key, on_h100, on_a100}) == 3


def test_compile_autotuned_hits_the_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    p = _port("jacobi3d")
    fn, label = at.compile_chain_autotuned(p, cache_path=path,
                                           device="cpu", trials=1)
    entry = json.load(open(path))[at.cache_key(
        p, "cpu", mxu="auto", mxu_precision="split", spill="auto")]
    assert entry["label"] == label and entry["reduced_precision"] is False
    assert entry["program"] == "jacobi3d" and entry["dimensions"] == [16] * 3
    assert entry["device"] == "cpu:cpu"
    assert entry["seconds"] == min(entry["timings"].values()) > 0
    assert set(entry) == {"label", "reduced_precision", "seconds", "timings",
                          "program", "dimensions", "device"}

    def boom(*a, **k):
        raise AssertionError("tuned again on a cache hit")
    monkeypatch.setattr(at, "autotune", boom)
    fn2, label2 = at.compile_chain_autotuned(p, cache_path=path,
                                             device="cpu")
    assert label2 == label
    inputs = _tensors(p, sft.load_input_arrays(p, seed=0))
    assert torch.equal(fn(inputs)[p.outputs[0]], fn2(inputs)[p.outputs[0]])


@pytest.mark.parametrize("stale", ["nonsense", "panel:B=4", "overlap:B=8"])
def test_stale_entry_and_force_tune_again(tmp_path, monkeypatch, stale):
    """A cached label that no longer builds (unknown: KeyError; not
    ported: NotImplementedError; a planner refusal: ValueError) is tuned
    again, on the same device; so is any entry under ``force``."""
    path = str(tmp_path / "autotune.json")
    p = _port("jacobi2d")
    with pytest.raises(ValueError):     # I = 1: no B = 8 overlap tile
        at.build_from_label(p, "overlap:B=8", device="cpu")
    key = at.cache_key(p, "cpu", mxu="auto", mxu_precision="split",
                       spill="auto")
    json.dump({key: {"label": stale}}, open(path, "w"))
    calls = []

    def fake(program, analysis=None, device="cuda", **kw):
        calls.append(str(device))
        fn = at.build_from_label(program, "xla", device=device)
        return at.AutotuneResult("xla", 1e-3, {"xla": 1e-3}, {}, fn)
    monkeypatch.setattr(at, "autotune", fake)
    _fn, label = at.compile_chain_autotuned(p, cache_path=path, device="cpu")
    assert label == "xla" and calls == ["cpu"]
    assert json.load(open(path))[key]["label"] == "xla"
    at.compile_chain_autotuned(p, cache_path=path, device="cpu")
    assert calls == ["cpu"]             # the fresh entry hits
    at.compile_chain_autotuned(p, cache_path=path, device="cpu", force=True)
    assert calls == ["cpu", "cpu"]


def test_cache_file_is_replaced_atomically(tmp_path):
    path = str(tmp_path / "sub" / "autotune.json")
    p = _port("jacobi3d")
    res = at.AutotuneResult("xla", 2e-3, {"xla": 2e-3, "stream": 3e-3}, {})
    assert at.save_result(p, res, path, "cpu") == path
    assert at.save_result(_port("jacobi2d"), res, path, "cpu") == path
    assert len(json.load(open(path))) == 2
    assert not (tmp_path / "sub" / "autotune.json.tmp").exists()


def test_default_cache_path(monkeypatch, tmp_path):
    monkeypatch.setenv("SFT_AUTOTUNE_CACHE", str(tmp_path / "x.json"))
    assert at.default_cache_path() == str(tmp_path / "x.json")
    monkeypatch.delenv("SFT_AUTOTUNE_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert at.default_cache_path() == str(
        tmp_path / "stencilflow_tpu_torch" / "autotune.json")


# -- (e) failures -------------------------------------------------------------
def _fake_builders(failing):
    def builders(program, analysis, device, **kw):
        from stencilflow_tpu_torch.backend import compile_chain
        return {"stream": failing,
                "xla": lambda: compile_chain(program, analysis)}
    return builders


def test_a_candidate_that_fails_to_build_raises_naming_it(monkeypatch):
    def nvcc_failed():
        raise RuntimeError("nvcc failed for stream")
    monkeypatch.setattr(at, "_builders", _fake_builders(nvcc_failed))
    with pytest.raises(RuntimeError, match="'stream' failed to build"):
        at.autotune(_port("jacobi3d"), labels=["stream", "xla"],
                    device="cpu", trials=1)


def test_a_candidate_that_fails_to_launch_raises_naming_it(monkeypatch):
    def refused(inputs):
        raise RuntimeError("kernel launch failed: CUDA error 1")
    monkeypatch.setattr(at, "_builders", _fake_builders(lambda: refused))
    with pytest.raises(RuntimeError, match="'stream' failed on cpu"):
        at.autotune(_port("jacobi3d"), labels=["stream", "xla"],
                    device="cpu", trials=1)


def test_a_scope_refusal_is_skipped(monkeypatch):
    def refuses():
        raise ValueError("out of the kernel's scope")
    monkeypatch.setattr(at, "_builders", _fake_builders(refuses))
    res = at.autotune(_port("jacobi3d"), labels=["stream", "xla"],
                      device="cpu", trials=1)
    assert res.label == "xla" and list(res.timings) == ["xla"]
    assert res.skipped == {"stream": "out of the kernel's scope"}


# -- (f) the timing loop ------------------------------------------------------
def test_timing_feeds_the_output_back():
    seen = []
    x = torch.ones(4, 5, 6)

    def fn(inputs):
        seen.append(inputs["a"])
        return {"out": inputs["a"] + 1}
    dt = at._time_fn(fn, {"a": x, "c": np.float32(2)}, 120, 1, False)
    assert np.isfinite(dt) and dt > 0
    assert any(s is not x for s in seen)   # outputs fed back


def test_timing_without_a_shape_compatible_pair():
    seen = []
    x = torch.ones(4, 5, 6)

    def fn(inputs):
        seen.append(inputs["a"])
        return {"out": inputs["a"].sum(0)}
    dt = at._time_fn(fn, {"a": x}, 120, 1, False)
    assert np.isfinite(dt) and dt > 0
    assert all(s is x for s in seen)    # the same input each time


def test_timing_falls_back_to_the_upper_bound(monkeypatch):
    seen = []

    def diff(run, n1, n2, trials):
        seen.append((n1, n2))
        return -1.0 if n1 else 4.0
    monkeypatch.setattr(at, "host_differenced_ms", diff)
    x = torch.ones(3, 3)
    dt = at._time_fn(lambda xs: {"o": xs["a"] * 2}, {"a": x}, 9, 1, False)
    assert seen[-1][0] == 0 and dt == 4.0 / 2 / 1e3


def test_a_slow_candidate_gets_a_shorter_loop(monkeypatch):
    seen = []
    monkeypatch.setattr(at, "TRIAL_BUDGET_S", 0.0)
    monkeypatch.setattr(at, "host_differenced_ms",
                        lambda run, n1, n2, trials: seen.append(
                            (n1, n2)) or 1.0)
    at._time_fn(lambda xs: {"o": xs["a"] * 2}, {"a": torch.ones(3)}, 3, 1,
                False)
    assert seen == [(1, 2)]


# -- (g) reduced precision ----------------------------------------------------
@pytest.mark.parametrize("kw", [dict(allow_reduced_precision=True),
                                dict(mxu_precision="bf16")],
                         ids=["allow_reduced_precision", "bf16"])
@pytest.mark.parametrize("entry", ["autotune", "compile_chain_autotuned"])
def test_reduced_precision_is_opt_in(entry, kw, tmp_path):
    """``allow_reduced_precision`` adds the bf16-ring labels to the
    measured set (never there without it), and its cache entries live
    under a key of their own, flagged when a bf16-ring label wins;
    ``mxu_precision="bf16"`` reaches the stream candidates (box-r2: its
    banded plan) and the key."""
    name = "box-r2" if "mxu_precision" in kw else "jacobi3d"
    p = _port(name)
    settings = dict(mxu="auto", mxu_precision=kw.get("mxu_precision",
                                                     "split"), spill="auto")
    if entry == "autotune":
        res = at.autotune(p, device="cpu", trials=1, **kw)
        plain = at.autotune(p, device="cpu", trials=1,
                            mxu_precision=settings["mxu_precision"])
        reduced = set(res.timings) & set(at.REDUCED_PRECISION_LABELS)
        assert not set(plain.timings) & set(at.REDUCED_PRECISION_LABELS)
        if kw.get("allow_reduced_precision"):
            assert reduced == set(at.REDUCED_PRECISION_LABELS)
        else:
            assert not reduced
            plan = at.build_from_label(p, "stream", device="cpu",
                                       **settings).plan
            assert plan.mxu_precision == "bf16" and plan.mxu_plans
        return
    path = str(tmp_path / "c.json")
    labels = ["panel:rings=bf16"] if kw.get("allow_reduced_precision") \
        else None
    fn, label = at.compile_chain_autotuned(p, device="cpu", cache_path=path,
                                           trials=1, labels=labels, **kw)
    entry_, = json.load(open(path)).values()
    flag = bool(kw.get("allow_reduced_precision"))
    key = at.cache_key(p, "cpu", **at._key_settings(settings, flag))
    assert json.load(open(path)) == {key: entry_}
    assert key != at.cache_key(p, "cpu", **at._key_settings(settings,
                                                             not flag))
    assert entry_["label"] == label
    assert entry_["reduced_precision"] == (label == "panel:rings=bf16") \
        == flag


# -- the driver ---------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_run_program_autotuned(name, tmp_path, monkeypatch):
    monkeypatch.setenv("SFT_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.chdir(tmp_path)
    p, res = _tuned(name)
    at.save_result(p, res, device="cpu", mxu="auto", mxu_precision="split",
                   spill="auto")
    out = run_program(p, device="cpu", backend="autotuned",
                      compare_to_reference=True, save_results=False,
                      log_level=0)
    assert out.backend == f"autotuned:{res.label}"
    assert out.verified_against_reference


def test_run_program_verifies_a_banded_winner_at_the_mxu_envelope(
        tmp_path, monkeypatch):
    """A cached banded stream winner runs, and verifies by the driver's
    rule for banded runs."""
    path = tmp_path / "at.json"
    monkeypatch.setenv("SFT_AUTOTUNE_CACHE", str(path))
    p = _port("box-r2")
    key = at.cache_key(p, "cpu", mxu="auto", mxu_precision="split",
                       spill="auto")
    json.dump({key: {"label": "stream"}}, open(path, "w"))
    assert _banded(at.build_from_label(p, "stream", device="cpu"))
    out = run_program(p, device="cpu", backend="autotuned",
                      compare_to_reference=True, save_results=False,
                      log_level=0)
    assert out.backend == "autotuned:stream"
    assert out.verified_against_reference
