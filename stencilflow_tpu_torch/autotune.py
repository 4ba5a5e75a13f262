"""Measured lowering selection: time every applicable lowering on the card
and cache the winner.

Port of ``stencilflow_tpu/autotune.py``.  ``--backend auto``
(``backend.compile_chain_best``) applies a fixed order of lowerings;
``autotune`` instead times THIS program on THIS device over the port's
lowerings (the kernels K1, K2, K3a/b/c, K5 and K6, the rows rotation and
``dense``) and caches the winner, so ``compile_chain_autotuned`` (and
``run --backend autotuned``) returns it at once on a hit.  Labels are
the JAX package's, so ``labels=``, cache entries and ``backend:
autotuned:<label>`` read the same in both packages; its labels that the
port does not build are in ``NOT_PORTED_LABELS``, each with its reason.

Timing: the candidate's output feeds an input of the same shape and
dtype where one exists, two applications a loop iteration, as the bench
does (``bench.feed_loop``); otherwise the candidate is applied again to
the same inputs.  Two loop lengths (``bench.loop_lengths``, at most the
JAX package's) are differenced, best of ``trials``, on CUDA events
(``probes.differenced_ms``; the host clock on the CPU), and a loop is
shortened where one iteration shows that a trial would run long
(``TRIAL_BUDGET_S``).  Inputs go to the device once, before timing.

Failures: a planner's ``ValueError`` / ``NotImplementedError`` when a
candidate is built is a scope refusal, recorded in ``skipped``.  Anything
else (an nvcc failure, a refused launch, a CUDA error) is a fault of the
port: it propagates, naming the label, and is never timed as infinite
(the JAX package records a failed Mosaic compile with an infinite time).
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where every candidate runs its plain version.

The bf16-ring labels (``REDUCED_PRECISION_LABELS``: K3 and K1 with bf16
rings, f32 compute) trade accuracy for shared memory, so they are
measured only under ``allow_reduced_precision`` (``autotune
--allow-reduced-precision``) or when named, and a winner among them is
flagged ``reduced_precision`` in the cache.

The cache key hashes the program's structure (``program_to_json`` without
data values), the device type and name, the lowering settings and the
reduced-precision flag where it is set; the
default file is ``$SFT_AUTOTUNE_CACHE``, else
``$XDG_CACHE_HOME/stencilflow_tpu_torch/autotune.json``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import ir
from .bench import feed_loop, loop_lengths
from .dtypes import to_torch
from .frontend.analysis import ChainAnalysis
from .probes import differenced_ms, host_differenced_ms

# the JAX package's labels that the port does not build, and why
NOT_PORTED_LABELS = {
    "stream:sm=off": "stage-major order is a TPU-only workaround (ROADMAP "
                     "North star, \"Don't port TPU-only workarounds\")",
    **{f"panel:B={B}": "the port's panel kernel (K1) marches one plane a "
                       "step, and the gate_frac=1.0 these labels carry "
                       "relaxes the TPU's VMEM gate (ROADMAP North star, "
                       "\"Don't port TPU-only workarounds\")"
       for B in (2, 4, 8)},
    **{f"rows:B={B}": "the port's compile_chain_rows takes panel= for the "
                      "group kernel only" for B in (16, 32, 64)},
    "rows:group:g=8:B=64:win=direct": "input_windows='direct' was kept off "
                                      "after measured negatives (ROADMAP "
                                      "North star)",
}

# the JAX package's DEFAULT_LABELS less the labels not ported, in order
DEFAULT_LABELS = ["stream", "stream:mxu=off", "panel:B=auto",
                  "overlap:B=auto", "group:g=2", "group:g=4", "rows:auto",
                  "rows:group:g=8:B=64", "pallas", "xla"]

# the JAX package's opt-in rounding envelopes (bf16 rings, f32 compute):
# never a default, measured only under ``allow_reduced_precision`` (or
# when named in ``labels``); a winner among them is flagged in the cache
# and verifies at BF16_VERIFY_RTOL
REDUCED_PRECISION_LABELS = ["stream:rings=bf16", "panel:rings=bf16"]

# a trial's longest loop, in seconds at the rate of one timed iteration
TRIAL_BUDGET_S = 0.25


def default_cache_path() -> str:
    return os.environ.get("SFT_AUTOTUNE_CACHE") or os.path.join(
        os.path.expanduser(os.environ.get("XDG_CACHE_HOME", "~/.cache")),
        "stencilflow_tpu_torch", "autotune.json")


def _overlap_at(program: ir.Program, analysis: ChainAnalysis, B: int,
                device):
    """K2 at the least-cost tile of ``OverlapPlan.candidates`` whose B
    (planes a block) is ``B``; ValueError where none fits."""
    from .backend.overlap import OverlapPlan, compile_chain_overlap
    best = min((c for c in OverlapPlan.empty(analysis).candidates(program)
                if c[1][0] == B), default=None)
    if best is None:
        raise ValueError(f"no overlap tile with B = {B} fits shared memory")
    return compile_chain_overlap(program, analysis, tile=best[1],
                                 device=device)


def _builders(program: ir.Program, analysis: ChainAnalysis, device,
              mxu: str = "auto", mxu_precision: str = "split",
              spill: str = "auto") -> Dict[str, Callable[[], Any]]:
    """label -> builder for every lowering of the port that might apply,
    in the JAX package's order.  ``mxu`` / ``mxu_precision`` / ``spill``
    forward to the stream candidates."""
    from .backend import (_any_mxu_candidate, compile_chain,
                          compile_chain_rows)
    from .backend.group import compile_chain_group
    from .backend.overlap import compile_chain_overlap
    from .backend.panel import compile_chain_panel
    from .backend.stream import compile_chain_stream
    from .backend.tile import compile_chain_tile

    b: Dict[str, Callable[[], Any]] = {}
    b["stream"] = lambda: compile_chain_stream(
        program, analysis, mxu=mxu, mxu_precision=mxu_precision,
        device=device, spill=spill)
    # bf16 rings, f32 compute (all-f32 programs, as the JAX package
    # offers them): half the rings' shared memory for a rounding a stage
    if all(np.dtype(program.field_dtype(f)) == np.float32
           for f in list(program.inputs) + list(program.kernels)):
        b["stream:rings=bf16"] = lambda: compile_chain_stream(
            program, analysis, mxu=mxu, mxu_precision=mxu_precision,
            device=device, spill=spill, ring_storage="bfloat16")
        b["panel:rings=bf16"] = lambda: compile_chain_panel(
            program, analysis, device=device, ring_storage="bfloat16")
    if mxu != "off" and _any_mxu_candidate(program):
        b["stream:mxu=off"] = lambda: compile_chain_stream(
            program, analysis, mxu="off", device=device, spill=spill)
    b["panel:B=auto"] = lambda: compile_chain_panel(program, analysis,
                                                    device=device)
    b["overlap:B=auto"] = lambda: compile_chain_overlap(program, analysis,
                                                        device=device)
    for B in (4, 8):
        b[f"overlap:B={B}"] = (lambda B=B: _overlap_at(program, analysis, B,
                                                       device))
    for g in (2, 4):
        b[f"group:g={g}"] = (lambda g=g: compile_chain_group(
            program, analysis, group=g, device=device))
        for B in (2, 4, 8):
            b[f"group:g={g}:B={B}"] = (lambda g=g, B=B: compile_chain_group(
                program, analysis, panel=B, group=g, device=device))
    if len(program.raw_dimensions) == 2:
        b["rows:auto"] = lambda: compile_chain_rows(
            program, device=device, mxu=mxu, mxu_precision=mxu_precision,
            spill=spill)[0]
        for g in (8, 4):
            b[f"rows:group:g={g}:B=64"] = (lambda g=g: compile_chain_rows(
                program, "group", group=g, panel=64, device=device)[0])
    b["pallas"] = lambda: compile_chain_tile(program, analysis,
                                             device=device)
    b["xla"] = lambda: compile_chain(program, analysis)
    return b


def _check_label(builders, label: str) -> None:
    """KeyError for a label no package knows; NotImplementedError naming
    the reason for one the port does not build."""
    if label in builders:
        return
    if label in NOT_PORTED_LABELS:
        raise NotImplementedError(f"autotune label {label!r} is not ported: "
                                  f"{NOT_PORTED_LABELS[label]}")
    raise KeyError(f"unknown autotune label {label!r}")


def build_from_label(program: ir.Program, label: str,
                     analysis: Optional[ChainAnalysis] = None,
                     device="cuda", **settings):
    """Rebuild a candidate's fn from its cached label."""
    analysis = analysis or ChainAnalysis.run(program)
    builders = _builders(program, analysis, device, **settings)
    _check_label(builders, label)
    return builders[label]()


def _time_fn(fn, arrs: Dict[str, Any], cells: int, trials: int,
             cuda: bool) -> float:
    """Seconds per application of ``fn`` on ``arrs`` (on the device)."""
    outs = fn(arrs)   # also validates the candidate end to end
    feed = next(((i, o) for o, v in outs.items() for i, a in arrs.items()
                 if torch.is_tensor(a) and a.shape == v.shape
                 and a.dtype == v.dtype), None)
    small, big, _ = loop_lengths(cells, cuda)
    if feed is not None:
        run, apps = feed_loop(fn, arrs, *feed), 2
    else:
        # no shape-compatible (input, output) pair: apply fn to the same
        # inputs again.  Eager torch hoists nothing out of a Python loop,
        # so the JAX package's 1e-30 carry (which keeps XLA from hoisting
        # the chain out of its fori_loop) is not needed
        def run(n):
            for _ in range(n):
                fn(arrs)
        # loop_lengths counts iterations of two applications
        apps, small, big = 1, 2 * small, 2 * big
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    run(1)
    sync()
    # shorten the loop where one iteration shows a trial would run long
    cap = int(TRIAL_BUDGET_S / max(time.perf_counter() - t0, 1e-9))
    big = max(2, min(big, cap))
    small = max(1, min(small, big // 5))
    diff = differenced_ms if cuda else host_differenced_ms
    dt = diff(run, small, big, trials) / apps / 1e3
    if dt <= 0:
        # differencing lost to timer jitter: the per-application upper
        # bound, so a noise-negative candidate can never win
        dt = diff(run, 0, big, trials) / apps / 1e3
    return dt


@dataclasses.dataclass
class AutotuneResult:
    label: str                      # winning candidate
    seconds: float                  # per chain application
    timings: Dict[str, float]       # label -> seconds
    skipped: Dict[str, str]         # label -> reason (out of scope)
    fn: Any = None                  # the winner's built callable
    # label -> seconds its builder took (plan and nvcc, all at once)
    build_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)


def _build_all(builders, labels: List[str]):
    """Run every builder at once (one nvcc each): ({label: fn},
    {label: scope refusal}, {label: seconds})."""
    def build(label):
        t0 = time.perf_counter()
        try:
            return builders[label](), time.perf_counter() - t0
        except (ValueError, NotImplementedError) as exc:
            return exc, time.perf_counter() - t0   # a planner's refusal
        except Exception as exc:  # noqa: BLE001 — named, then re-raised
            raise RuntimeError(f"autotune: candidate {label!r} failed to "
                               f"build: {type(exc).__name__}: {exc}") \
                from exc

    with ThreadPoolExecutor(max_workers=max(1, min(
            len(labels), os.cpu_count() or 1))) as pool:
        got = dict(zip(labels, pool.map(build, labels)))
    fns = {l: f for l, (f, _) in got.items() if not isinstance(f, Exception)}
    skipped = {l: str(f) for l, (f, _) in got.items() if l not in fns}
    return fns, skipped, {l: s for l, (_, s) in got.items()}


def autotune(program: ir.Program,
             analysis: Optional[ChainAnalysis] = None,
             labels: Optional[List[str]] = None,
             sweep: bool = False,
             trials: int = 3,
             seed: int = 0,
             device="cuda",
             verbose: bool = False,
             mxu: str = "auto",
             mxu_precision: str = "split",
             spill: str = "auto",
             allow_reduced_precision: bool = False) -> AutotuneResult:
    """Time every applicable lowering on ``device`` and return the winner.

    ``sweep`` adds the explicit overlap / group block sizes and the second
    rows group to the default candidates.  Candidates whose planners
    refuse the program are recorded in ``skipped``; any other failure
    raises, naming the label.  ``allow_reduced_precision`` adds the
    opt-in rounding envelopes (``REDUCED_PRECISION_LABELS``, bf16 rings)
    to the measured set, which selects on speed alone and so never takes
    them otherwise; explicit ``labels`` bypass the filter.
    ``mxu_precision="bf16"`` forwards to the stream candidates."""
    from .data import load_input_arrays
    from .backend.stacked_io import resolve_device
    device = resolve_device(device)
    analysis = analysis or ChainAnalysis.run(program)
    builders = _builders(program, analysis, device, mxu=mxu,
                         mxu_precision=mxu_precision, spill=spill)
    if labels is None:
        labels = [l for l in (list(builders) if sweep else DEFAULT_LABELS)
                  if l in builders and l not in REDUCED_PRECISION_LABELS]
        if allow_reduced_precision:
            labels += [l for l in REDUCED_PRECISION_LABELS
                       if l in builders]
    for label in labels:
        _check_label(builders, label)
    arrs = {k: v if program.inputs[k].is_scalar
            else to_torch(v, device)
            for k, v in load_input_arrays(program, seed=seed).items()}
    fns, skipped, build_s = _build_all(builders, labels)
    timings: Dict[str, float] = {}
    for label in [l for l in labels if l in fns]:
        try:
            dt = _time_fn(fns[label], arrs, program.total_elements, trials,
                          device.type == "cuda")
        except Exception as exc:  # noqa: BLE001 — named, then re-raised
            raise RuntimeError(f"autotune: candidate {label!r} failed on "
                               f"{device}: {type(exc).__name__}: {exc}") \
                from exc
        timings[label] = dt
        if verbose:
            gc = program.total_elements / dt / 1e9
            print(f"  {label:16s} {dt * 1e3:9.3f} ms  {gc:8.2f} GCell/s  "
                  f"(built in {build_s[label]:.1f} s)")
    if not timings:
        raise RuntimeError(f"autotune: no candidate ran ({skipped})")
    best = min(timings, key=timings.get)
    return AutotuneResult(label=best, seconds=timings[best],
                          timings=timings, skipped=skipped, fn=fns[best],
                          build_seconds=build_s)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def cache_key(program: ir.Program, device="cuda", **settings) -> str:
    """Device-, settings- and structure-dependent key (data values
    excluded): a winner measured on another card, on the CPU or with
    other lowering settings is never served."""
    from .frontend.export import program_to_json
    device = torch.device(device)
    spec = program_to_json(program, embed_data=False)
    ctx = "|".join(f"{k}={settings[k]}" for k in sorted(settings))
    src = (json.dumps(spec, sort_keys=True, default=str)
           + f"|{device.type}|{_device_name(device)}|{ctx}")
    return hashlib.sha256(src.encode()).hexdigest()[:16]


def _load_cache(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_cache(path: str, cache: Dict[str, Any]) -> None:
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _key_settings(settings, allow_reduced_precision: bool):
    """The cache key's settings: the flag joins them where it is set, so
    that a bf16-rings winner tuned under it is never served to a run
    that did not opt in."""
    return dict(settings, allow_reduced_precision=True) \
        if allow_reduced_precision else dict(settings)


def save_result(program: ir.Program, res: AutotuneResult,
                cache_path: Optional[str] = None, device="cuda",
                allow_reduced_precision: bool = False,
                **settings) -> str:
    """Record an AutotuneResult in the on-disk cache (under the key of
    ``settings`` and ``allow_reduced_precision``); returns the path."""
    path = cache_path or default_cache_path()
    device = torch.device(device)
    cache = _load_cache(path)
    cache[cache_key(program, device, **_key_settings(
            settings, allow_reduced_precision))] = {
        "label": res.label,
        # a bf16-rings winner carries a rounding envelope: run --backend
        # autotuned verifies it at BF16_VERIFY_RTOL
        "reduced_precision": ":rings=bf16" in res.label,
        "seconds": res.seconds,
        "timings": res.timings,
        "program": program.name,
        "dimensions": list(program.raw_dimensions),
        "device": f"{device.type}:{_device_name(device)}",
    }
    _save_cache(path, cache)
    return path


def compile_chain_autotuned(program: ir.Program,
                            analysis: Optional[ChainAnalysis] = None,
                            cache_path: Optional[str] = None,
                            force: bool = False,
                            device="cuda",
                            mxu: str = "auto",
                            mxu_precision: str = "split",
                            spill: str = "auto",
                            allow_reduced_precision: bool = False,
                            **autotune_kw) -> Tuple[Any, str]:
    """Return ``(fn, label)`` for the measured-best lowering, consulting
    (and updating) the on-disk cache; ``force`` tunes again.  A cached
    label that no longer builds (KeyError, ValueError,
    NotImplementedError) is tuned again on the same device.
    ``allow_reduced_precision`` is part of the cache key."""
    path = cache_path or default_cache_path()
    settings = dict(mxu=mxu, mxu_precision=mxu_precision, spill=spill)
    key = cache_key(program, device, **_key_settings(
        settings, allow_reduced_precision))
    cache = _load_cache(path)
    if not force and key in cache:
        label = cache[key]["label"]
        try:
            return (build_from_label(program, label, analysis,
                                     device=device, **settings), label)
        except (KeyError, ValueError, NotImplementedError):
            pass   # a stale entry: tune again
    res = autotune(program, analysis, device=device, **settings,
                   allow_reduced_precision=allow_reduced_precision,
                   **autotune_kw)
    save_result(program, res, path, device, allow_reduced_precision,
                **settings)
    return res.fn, res.label
