#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (stencilflow_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card, < 20 minutes

Phases, one line each (any failure raises and exits non-zero):

1. device: ``nvidia-smi`` name and power limit, torch's device name;
2. build: every kernel of phases 3 to 7 and 9 generated and compiled at
   once, one nvcc per source, all started together (kernels are built
   from the checkout's sources; phase 7's, phase 9's and phase 4's
   autotune candidates through the entry points' own compile calls, on
   threads beside);
3. kernel vs plain version on the card (one compact case of each kind; the
   wider matrix of programs, BCs and types of each kernel runs in
   tests/test_torch_cuda.py): the panel and overlap kernels, each forced
   through its own plan, and the overlapped-tile kernel (K6), masked and
   fast (one launch: mask-free interior blocks, masked border blocks),
   against their plain versions (K6 fast: mask-free plus the torch fix-up
   of the border shell) on the float64 random chain with shrink BCs and the
   int32 one (scalar and lower-rank inputs), bit-exact or within
   VERIFY_RTOL where a transcendental appears; the overlap kernel alone on
   hotspot3d 24 x 40 x 72 x 2 (on its rule's plan, at B = 4 with runs of 4
   j cells and the register window, and as the skeleton alone) and jacobi2d
   96 x 200 x 2 (I = 1); the stream kernel against its plain version on box
   chains of extent 1 and 2 (composed), a box with constant BC 0.7
   (per-stage plans with correction planes), a shrink box, a radius-2 cross
   (rank 2, per stage) and a per-cell stage feeding a wide affine stage
   that reads two fields, each banded case also with its band passes on the
   other route (tensor cores against CUDA cores), within MXU_VERIFY_RTOL
   (the plain version applies the bands with torch.matmul, another
   summation order); the group kernel against its plain version, bit-exact,
   on jacobi2d 256 x 192 x 8 through rows with shrink BCs (g = 8, B = 64)
   and a 3-D jacobi with i-offsets of 3 at g = 2, B = 2; the local chunk
   kernel K4 against its plain version, chunk by chunk, on jacobi3d 64^3 x
   3 at 4 chunks (constant / copy / shrink BCs), the hdiff DAG at 4 chunks
   (i-halo 0), a box chain of extent 2 banded per stage at 2 chunks and the
   3-D fuzz chain (bit-exact per cell, MXU_VERIFY_RTOL banded); the stream
   kernel of the spill rung (K3c: shared memory packed by liveness, spilled
   rings staged and moved by bulk asynchronous copies) on jacobi3d 64^3 x 3
   with shrink BCs and every ring spilled, and K4 with every ring spilled
   at 4 chunks, bit-exact; the reduced-precision modes against their plain
   versions: bf16 rings (``ring_storage="bfloat16"``) bit for bit in K1
   (jacobi3d 40 x 48 x 72 x 4), K5 (jacobi2d 256 x 192 x 8 through rows),
   K3a (the same jacobi3d per cell) and K3c (the reconvergent chain under
   its budget), and single-pass bf16 band passes (``mxu_precision=
   "bf16"``, K3b) held by ``stream.bf16_passes_agree`` against their plain
   version and apart from the split route, on box-r2 (CUDA cores, then
   tensor cores) and cross-r2; bf16 compute (``compute_dtype="bfloat16"``:
   bf16 inputs, rings, math and outputs) against its plain version by
   ``stream.bf16_compute_agree`` (bit for bit per cell, the banded rule
   banded) in K3a (jacobi3d 40 x 48 x 72 x 4, hotspot3d with constant BC
   0.3), K3b (the box of BC 0.7, both routes) and K3c (jacobi3d 64^3 x 3
   with every ring spilled), and float16 compute
   (``compute_dtype="float16"``) the same way on the hotspot, the box
   (CUDA-core split passes) and the spilled jacobi; programs typed bfloat16
   and float16 (``_narrow_small``) against their plain versions and the
   host oracle, bit for bit (one bf16 ulp from the oracle where a
   transcendental appears), in K1 (hdiff3d 40 x 48 x 72 x 3), K2 (jacobi3d
   x 2), K3a (jacobi3d x 4), K3c (jacobi3d 64^3 x 3, every ring spilled)
   and K5 (jacobi2d 256 x 192 x 8 through rows), and two mixed bf16
   programs (K1, K3a) and bf16 meeting f16 (K1); K4 chunk by chunk at 4
   chunks and K6 fast on hdiff3d 64^3 x 3 typed f16 (``_nk_small``), every
   launch against its plain version and the assembled output against the
   host oracle, bit for bit, each counted under its narrow mode; the
   compute types of programs typed other than float32 and int32 and bool
   compute (``_ct_small``): float32, bf16 and f16 compute on the mixed-type
   chain and on the bf16 chain with an int32 stage (24 x 40 x 72), int32
   and bool compute on jacobi3d 64^3 x 3 on [-1000, 1000), each as K3a and
   as K3c (``spill="all"``), against its plain version bit for bit (within
   VERIFY_RTOL where a transcendental meets float32 compute), counted under
   ``stream.compute_key``, timed in turns with the same program's f32
   compute (under f32 compute: its own types) beside its plain version's
   ms, its bound and the library call (chained F.conv3d in the compute type
   where one computes the chain and cuDNN takes the type, else "none" and
   why);
4. the ``run`` main path at full size through ``run_program(...,
   device="cuda")``: jacobi3d 512^3 x 8 (panel), jacobi3d 512^3 x 2
   (overlap), hdiff3d and hotspot3d 256^3 x 8 (panel), box3d 256^3 x 8 of
   extent 2 (stream, all 8 stages composed) and cross3d 256^3 x 8 of
   extent 2 (stream, per stage), jacobi2d and hotspot2d 8192^2 x 8
   (rows+group_g8), hdiff2d 8192^2 x 16 (panel: its rings of one plane
   packed by liveness; the stream kernel's packed plan timed beside), the
   deep 3-D chains jacobi3d
   512^3 x 32, hdiff3d 256^3 x 16 and hotspot3d 256^3 x 24 (the spill
   rung, K3c, 3 repetitions), and K6 forced
   through ``backend="tile"`` (its fast mode) on jacobi3d 512^3 x 2 and
   hdiff3d 256^3 x 8, each verified against the dense lowering on the
   card and, up to 256^3 and for the two 8192^2 x 8 cells, against the
   numpy oracle
   (bit-exact for the per-cell kernels, MXU_VERIFY_RTOL for the banded
   stream ones); kernel launch counts are reset just before and read
   just after, and each kernel must have been launched.  The stream cells
   also print the forced-panel time where the panel planner accepts the
   program; before the main path, box and cross on the stream kernel
   against its plain version with their tile, threads, packed and
   unpacked shared memory, resident blocks per SM, stage evaluations a
   cell and the band passes' route, each timed in turns with its plan on
   the other route (route, other, other, route); the 2-D cells the forced
   overlap kernel on the unrotated
   plane (the port's route before the rows path) and forced rows+panel,
   the forced K6 cells the route's time; before the main path, K1 on
   each panel cell (jacobi3d 512^3 x 8, hdiff3d and hotspot3d 256^3 x 8)
   against its plain version bit for bit, with its tile, packed and
   unpacked shared memory, resident blocks per SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), masked share,
   time and bound, K2 on jacobi3d 512^3 x 2 with its plan ((B, tj, tk),
   R, register window, blocks along i, threads, resident blocks per SM,
   shared memory), and K3c on
   each deep cell against its plain version bit for bit, with its time,
   share of the bound, spill traffic a call against the copy floor,
   spilled rings, loads a step and resident blocks per SM, and the dense
   lowering's time beside it, and K5 on jacobi2d and hotspot2d 8192^2 x 8
   and K6 on jacobi3d 512^3 x 2 (masked, then fast) against their plain
   versions bit for bit, with tile, threads, i-segments, shared memory,
   resident blocks per SM, time and bound; after the main path, one
   ``F.conv3d`` (``F.conv2d`` for jacobi2d) per stage, chained (TF32
   off), is timed for the linear chains as a library yardstick the port
   never calls; then the autotuned main path on cross3d 256^3 x 8 of
   extent 2: ``compile_chain_autotuned`` with the default labels, one
   trial and a temporary cache (each label's ms, the skipped labels and
   the phase-2 build seconds printed; every timed candidate's kernel
   launched, counts reset just before and read just after), each
   measured candidate equal to the dense lowering (bit-exact per cell,
   MXU_VERIFY_RTOL banded), a second call served from the cache, and
   ``run_program(..., backend="autotuned", compare_to_reference=True)``
   verified, the winner's kernel launched.  The reduced-precision legs:
   before the main path, each mode's kernel at its leg's shape against
   its plain version (bf16 rings bit for bit, bf16 passes as in phase 3)
   with its plan (tile, shared memory, spilled rings),
   time and bound; after it, with the counts set to 0 just before and
   read just after, jacobi3d 512^3 x 8 ``--backend panel --ring-storage
   bfloat16`` (K1), jacobi3d 512^3 x 32 ``--backend stream --ring-storage
   bfloat16`` (K3c), jacobi2d 8192^2 x 8 through ``compile_chain_rows(p,
   "group", group=8, panel=64, ring_storage="bfloat16")`` (K5) and box3d
   256^3 x 8 of extent 2 ``--backend stream --mxu-precision bf16`` (K3b),
   each held to its plain version again and within BF16_VERIFY_RTOL of
   its cell's f32 route on the same inputs wherever its plain version is
   (one rule for every leg; the line prints both drifts), with both
   times; then bf16 compute (``compile_chain_stream(compute_dtype=
   "bfloat16")``) on jacobi3d 512^3 x 8 (K3a) and box3d 256^3 x 8 of
   extent 2 (K3b, tensor cores): the kernel against its plain version,
   timed in turns with the f32 stream kernel on the same tile, its drift
   from f32, one chained ``F.conv3d`` in bf16, and the leg through the
   entry point with the count set to 0 just before and read just after;
   then the compute types' three cells (``_ct_legs``, K3a): jacobi3d
   512^3 x 8 typed bf16 under float32 compute, jacobi3d 512^3 x 8 on
   [-1000, 1000) under int32 compute and the mixed-type chain at the
   largest cube up to 512^3 whose plan fits under bf16 compute, each
   kernel against its plain version bit for bit, timed in turns with
   the same program's f32 compute (under f32 compute: its own types),
   with its plain version's ms, bound and library call, then the cell
   through ``compile_chain_stream`` with its ``compute_key`` count set to
   0 just before and read just after (one launch, equal to the kernel);
   then programs typed bf16 and f16 (``_narrow_legs``): jacobi3d 512^3 x
   4 bf16 and f16 (K1), x 2 bf16 (K2), x 4 bf16 with ``--backend
   stream`` (K3a) and jacobi2d 8192^2 x 8 bf16 (rows+group_g8, K5), each
   through ``run_program`` with the narrow counts set to 0 just before
   and read just after, the kernel against its plain version and the
   main path's output bit for bit, both timed, with one chained
   ``F.conv3d``/``conv2d`` in the program's type; float16 compute on
   jacobi3d 512^3 x 8 (K3a) as bf16 compute's legs; K6 on jacobi3d 512^3
   x 2 typed bf16 and f16 (``_nk_tiles``): ``run --backend tile`` (fast
   mode, 11 narrow launches) and ``compile_chain_tile(mode="masked")``,
   the counts set to 0 just before and read just after, the kernel
   against its plain version and the entry point's output bit for bit,
   timed beside 2 chained ``F.conv3d`` in the program's type;
5. the out-of-core path (``run --host-chunks N``) through
   ``run_program(..., host_chunks=N, device="cuda")``: jacobi3d 1024^3 x
   8 at 8 chunks and hotspot3d 512^3 x 8 at 4 chunks, each bit-equal to
   the in-core route (panel) on the same inputs, K4 launched N times per
   call (counts reset just before, read just after), the device memory
   peak (jacobi: below a third of the in-core input and output), the time
   per call with transfers, the bytes over the host link and the link
   bound from the pinned copy rates measured with 1 GiB ``copy_``s; K4
   alone on one jacobi chunk beside its plain version and 8 chained
   ``F.conv3d`` over the widened chunk, with its tile, threads, packed
   and unpacked shared memory, resident blocks and evaluations a cell;
   then K4's single-pass bf16 passes (``run --host-chunks 4
   --mxu-precision bf16``) on box3d 512^3 x 8 of extent 2: K4 alone on
   the middle chunk against its plain version (``bf16_passes_agree``,
   apart from the split chunk plan's plain version) and in turns with
   the split chunk kernel, then the out-of-core call with the counts
   reset just before and read just after (K4's bf16 launches 4 a call,
   nothing else), within BF16_VERIFY_RTOL of the in-core f32 route; then
   ``run --host-chunks 8`` on jacobi3d 1024^3 x 8 typed bf16
   (``_nk_outofcore``): K4 alone on the middle chunk against its plain
   version, then the call with the counts reset just before and read just
   after (K4's narrow launches 8 a call, nothing else), bit-equal to the
   in-core narrow route (K1), its ms a call, link bytes and link bound;
6. the measurement path: the probes' kernels against their plain
   versions on the card (P4's copy of 512 x 512^2 bit-equal to its input
   and timed beside ``copy_``; P1's every op at 8 steps, bit-exact or
   within ``alu_ceiling.TOLERANCE``), then, each with its launch count
   reset just before and read just after, P4's flat and tiled copies, one
   differenced P1 timing of add, fma, fma_fused and the shared-memory
   add, P7 at U = 1 and 2, eager and graph, at 512 and 8 planes (both
   ping-pong buffers bit-equal to the input after every case; its
   launches are P4's count over P7's run), and one session of ``python
   -m stencilflow_tpu_torch.bench --workload jacobi`` (its JSON line
   printed), each of whose bound fractions must be at most 1; then P7's
   loop at 512 planes, U = 2, with its plain version and with ``copy_``
   as the body.  The graph-timed probes (P4, P7) count eager launches
   and graph captures: a replay re-runs the captured launches without
   passing through the wrapper.  P1's variant bodies of the TPU script
   (mul4, expr_jac2d, expr_jac2d_shift, the three flux-limiter
   formulations, selc and maskmul) each measured with its count reset
   just before and read just after, then timed at 8 steps beside its
   plain version.  Then the design probes: P6 (dep and
   indep, out and acc) and P3 (direct and the cp.async ring, every S) at
   1, 2 and all blocks per SM, P2 in every variant and P5 in every walk,
   each against its plain version bit for bit at ragged shapes and at
   the main shape (512^3; P2 33 x 33 over 256 steps of 256^2), P5
   against K2 (the overlap kernel) on the same chain written as a
   StencilFlow program; one timed case per probe (P6 dep N = 16, P3 ring
   S = 4 N = 16 at 1 block per SM, P2's four variants, P5 B = 8 (16, 64)
   beside K2 and two chained ``F.conv3d``), each count reset just before
   and read just after.

7. the solver entry points at full width, each wrapper's count reset
   just before and read just after (K1, K2 and K4 must launch, and K5
   where Gray-Scott routes there; a graph replay re-runs its captured
   launches without the wrappers, so the counts see warm-ups and
   captures): ``iterate`` on jacobi3d 512^3 (one stage), 64 steps, fused
   by 8 (K1) and one stage a step (K2), the two bit-equal and equal to
   the dense lowering stepped 64 times eagerly, each with its ms a step
   from a CUDA-graph replay beside K1's one-shot 8-stage time; Gray-Scott
   8192^2 (the two fields of ``examples/gray_scott.py`` fed back, copy
   BCs) fused by 4 and not fused, bit-equal to each other and to dense
   stepping, 16 steps; ``iterate --host-chunks 8`` on jacobi3d 1024^3
   fused by 8 (K4), 16 steps, bit-equal to in-core ``iterate`` (K1);
   ``fast_value_and_grad`` on jacobi3d 512^3 x 8 and on the same chain
   at 256^3 with copy BCs (the adjoint's 1-D indicator inputs on a
   kernel), each gradient equal to the dense lowering of the adjoint
   program on the same cotangent bit for bit, with routes, ms and the
   device's peak memory, and ``value_and_grad`` (dense autodiff) beside
   each within VERIFY_RTOL, with its time and peak; ``solve_cg`` on backward-Euler
   diffusion 512^3 and ``solve_cgnr`` on an upwind operator at 512^3,
   their iterations, true relative residuals (at most 100 tol) and ms an
   iteration split into operator and vector passes, and CG at 4 host
   chunks cut to its first 4 iterations (for the script's time) within
   10 tol of the in-core solver's x at the same iteration.  Then the
   narrow legs (``_nk_solvers``): ``iterate`` on jacobi3d 512^3 typed
   bf16 fused by 8, checkpointed at step 16 and resumed to 32, bit-equal
   to the uninterrupted run; ``fast_value_and_grad`` on jacobi3d 256^3 x
   8 bf16, its gradient bit-equal to the adjoint's dense lowering; CG on
   backward Euler 512^3 typed float16, 4 iterations.

8. the simulator: ``run --run-simulation`` through ``run_program(...,
   device="cuda", run_simulation=True, compare_to_reference=True)`` on
   jacobi3d 256^3 x 8 (K1), jacobi3d 256^3 x 2 (K2), hotspot2d 4096^2 x 4
   (K5, rows+group_g8), box3d 128^3 x 4 of extent 2 (K3b, banded stages,
   MXU_VERIFY_RTOL; both cut from 8 stages to keep the script's time) and a mixed-dtype chain (int32 / bool / float stages)
   at 48^3, each leg's native simulator core (g++) and kernel (nvcc)
   built first, all at once; the 256^3 x 8 leg on one thread, the others
   in turn on another (the simulator and the oracle run on the host); each
   verified against the simulator and the oracle, the per-cell ones
   bit-equal to the simulator, with the kernels' counts reset just
   before the legs and read just after (each leg's kernel must launch)
   and the simulator's cycles, host seconds, Mcycles/s and g++ seconds
   printed; beside the legs, ``python -m stencilflow_tpu_torch.cli
   simulate`` with ``--trace-chrome`` on a 16^3 program in a subprocess
   (exit 0, a non-empty trace with activity spans), and in another
   ``cli import-sdfg tests/fixtures/hdiff.sdfg --dimensions 256,256,256
   --input-data random:0,1`` then ``cli compile`` of the program it
   wrote (exit 0, the program JSON-equal to ``sdfg_to_program``'s, a
   non-empty ``.cu`` equal to ``backend.route_source``'s and a built
   library); after the legs, that imported program through
   ``run_program(..., device="cuda", compare_to_reference=True)`` on K1
   (the panel route; K1's count reset just before and read just after,
   the outputs equal to the oracle's bit for bit), with its kernel time
   and bound printed.

9. the sharded engine (``parallel/domain.py compile_sharded_chain``) on
   meshes of virtual shards repeating the one card (not a multi-GPU
   scaling figure): K4 per shard (``sf_shard_launch``: a 3-D origin,
   inputs widened by the exchanged halo, per-shard band pools) against
   its plain version shard by shard on jacobi3d 64^3 x 3 (constant /
   copy / shrink BCs) over 2 x 2 x 2 and a box of extent 1 with constant
   BC 0.7 over 2 x 2 (bit-exact, MXU_VERIFY_RTOL banded); then jacobi3d
   512^3 x 8 over 2 x 2 ``(None, x, y)`` and over 4 shards of i, hdiff3d
   256^3 x 8 with copy BCs over 2 x 2 and box3d 256^3 x 8 of extent 2
   over 2 x 2 (composed, stacked per-shard bands), each driven once with
   the counts reset just before and read just after (K4's shard launches
   equal the shards, nothing else launched), equal to the single-device
   route on the same inputs (box within MXU_VERIFY_RTOL), and its last
   shard (non-zero origins in every sharded dim) through K4 against its
   plain version at that shape (bit-exact, box within MXU_VERIFY_RTOL),
   with its ms a call, one shard's K4 ms and plain-version ms, the
   exchange's ms and bytes and the single-device route's ms; ``iterate`` on jacobi3d 256^3 over 2 x 2, 16
   steps fused by 8 (CUDA-graph replays), equal to in-core ``iterate``,
   and ``fast_value_and_grad`` on jacobi3d 128^3 x 8 over 2 x 2, equal to
   the single-device gradient.  Then the pipeline split
   (``parallel/pipeline.py compile_pipeline_split``) over positions
   repeating the card, K4 a segment in chunk mode: jacobi3d 512^3 x 8
   over 4 ``("p",)`` in sharded and in replicated io, box3d 256^3 x 8 of
   extent 2 over 2 (banded segments) and jacobi3d 512^3 x 8 over ``("p",
   "x")`` 2 x 2 with j over x (the dense tile body, as the reference's
   ``domain_axes``), each driven once with the counts reset just before
   and read just after (K4 launched segments x chunks, nothing else; the
   dense cell launches no kernel), equal to the single-device route (box
   within MXU_VERIFY_RTOL), with its ms a call beside the route's; the
   first cell's segment 0 through K4 against its plain version at the
   main path's shape (every plane bit-exact), with its ms, plain-version
   ms, bound, the chained ``F.conv3d`` over its tile, and one cut's
   carry with the ms of a device copy of it (what a hop between distinct
   devices copies; on the repeated card a hop copies nothing).  Then
   K4's reduced precisions beside their f32 cells: bf16 rings on
   jacobi3d 512^3 x 8 over 2 x 2 and single-pass bf16 passes on box3d
   256^3 x 8 of extent 2 over 2 x 2 (shard mode) and over 2 pipeline
   positions (segment mode), each driven once with the counts reset just
   before and read just after (K4's bf16 launches only), within
   BF16_VERIFY_RTOL of its f32 cell, and one launch at that shape (the
   last shard; segment 0 on chunk 1) against its plain version (rings
   bit for bit, passes by ``bf16_passes_agree``) and timed in turns with
   the f32 cell's kernel on the same tiles.  Then the comm/compute
   overlap (``comm_overlap=True``: the exchange on a side stream, the
   interior K4 on the compute stream, two strip K4s a shard after it) on
   jacobi3d 512^3 x 8 over 4 shards of i and box3d 256^3 x 8 of extent 2
   over 2 (banded): once with the counts reset (K4 launches 3 x shards),
   held to the uncomposed blocking call over 11 calls, timed in turns
   with it beside the exchange and the blocking route, and the first
   cell's interior and strip K4s against their plain versions.  Then
   jacobi3d 512^3 x 8 typed bf16 (``_nk_sharded``) over 2 x 2 and over 4
   pipeline positions, each driven once with the counts reset just
   before and read just after (K4's narrow launches only), bit-equal to
   the single-device narrow route, and the last shard and segment 0 on
   chunk 1 through K4 against its plain version, timed.  Then the
   multi-host surfaces (``_multihost``): two processes of ``cli
   run-distributed --coordinator 127.0.0.1:PORT --num-hosts 2 --host-id
   {0,1} --devices 2 --compare-to-reference`` on jacobi3d 256^3 x 8, a
   position a process on cuda:0, exchanging over gloo through pinned
   host buffers, for domain blocking, domain ``--comm-overlap`` and
   pipeline (the three pairs at once, killed on a timeout): each process
   exits 0, verifies the shards it holds and launches K4; one timed pair
   of ``_timed_host`` processes on jacobi3d
   512^3 x 8 (ms a call, the exchange's ms, the bytes a rank received
   beside ``mesh_scaling``'s ``ici_bytes_per_device``; both ranks share
   the card, no scaling figure); ``iterate`` with
   ``checkpoint_format="orbax"`` (``torch.distributed.checkpoint``, a
   directory a step, one entry a shard) over 2 x 2 virtual shards at
   256^3, the newest step removed and the resume bit-equal to the
   uninterrupted run, with the save's ms and a chunk's wall with and
   without a save; and the mesh-scaling model's line for jacobi3d 512^3 x
   8 over 2 x 2 (the exchange at the NVLink data-sheet rate).

Phases 3 to 5 and 9 draw each program's inputs once a phase
(``_InputMemo``: ``run_program`` and the script take the same seeded
arrays from a memo), equal arrays compare without float64 copies
(``_compare``), and phase 4 prints the seconds of its sections and of
each main-path cell, with the time it waited for the cell's oracle.

Every bound comes from the port's report (report.py): the larger of the
minimum bytes over the data sheet's 3.35e12 B/s and the faster compute
strategy's operations over the single-instruction FP32 rate.  The last
lines are the card line, a JSON object of the kernels (launches from
phase 4, K4's from phase 5, the probes' from phase 6 and K4 per shard's
and per segment's from phase 9; error, kernel, plain-version and library
times measured in this run at the main path's shapes, bounds computed
from its inputs; 55 entries: the stream kernel's on box and on cross,
the four reduced-precision modes' from phase 4's bf16 legs and its two
bf16-compute legs, K4's bf16 passes on chunks from phase 5, P1's eight
variant bodies from phase 6, and K4's three reduced-precision legs and
the overlap's interior and strip K4s from phase 9, and the six rows of
programs typed bf16 and f16: K1, K1 f16, K2, K3a and K5 from phase 4's
narrow legs, ``_narrow_legs``, and K3c from phase 3, and eight more:
K3a under float16 compute and K6 fast and masked on bf16 and f16
programs from phase 4, K4 chunk on a bf16 program from phase 5, K4 per
shard and per segment on it from phase 9, and the compute types' five
keys: f32 compute of a bf16 program, int32 compute and bf16 compute of
the mixed-type chain from phase 4's cells, f16 compute of a program
typed otherwise and bool compute from phase 3) and
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def _routes(plan) -> str:
    """The band passes of an on-chip stream plan by width: "33-tap mma"
    (tensor cores) or "5-tap fma" (CUDA cores)."""
    return ", ".join(sorted({
        f"{plan.band_info(k, side).taps}-tap {plan.route(k, side)}"
        for t in plan.tkeys for k, side in ((t[1], "L"), (t[2], "R"))
        if k is not None}))


def _has_transcendental(program) -> bool:
    from stencilflow_tpu_torch import ir
    return any(isinstance(n, ir.Call) and n.fn not in ("min", "max", "abs")
               for k in program.kernels.values() for s in k.statements
               for n in ir.walk(s.rhs))


def _i_window(v, lo: int, n: int):
    """Planes ``lo .. lo + n`` of ``v`` along i, zero past its ends."""
    import torch
    a, b = max(lo, 0), min(lo + n, v.shape[0])
    rest = tuple(v.shape[1:])
    return torch.cat([v.new_zeros((a - lo,) + rest), v[a:b],
                      v.new_zeros((lo + n - b,) + rest)])


def _compare(a: np.ndarray, b: np.ndarray, rtol: float):
    """(ok, max abs diff): bit-exact (NaN == NaN) when rtol is 0.  Equal
    arrays return at once: the float64 differences of a 512^3 pair take
    seconds on the host, and most pairs here are equal."""
    from stencilflow_tpu_torch.data import arrays_are_equal
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False, float("inf")
    if np.array_equal(a, b):
        return True, 0.0
    with np.errstate(invalid="ignore"):
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    both_nan = np.isnan(a.astype(np.float64)) & np.isnan(b.astype(np.float64))
    err = float(np.max(np.where(both_nan, 0.0, d))) if d.size else 0.0
    if rtol == 0:
        ok = np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    else:
        ok = arrays_are_equal(a, b, rtol)
    return ok, err


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _mixed_spec(dims):
    """A per-cell stage feeding a wide affine stage that reads two fields
    (a rank-1 box of s0 with a constant-0.2 BC, a rank-2 cross of b), an
    (i, k) input, a scalar and a bias; then a narrow per-cell stage."""
    box = " + ".join(f"s0[i{di:+d},j{dj:+d},k{dk:+d}]"
                     for di in (-1, 0, 1) for dj in (-1, 0, 1)
                     for dk in (-1, 0, 1))
    cross = " + ".join(f"b[i{o[0]:+d},j{o[1]:+d},k{o[2]:+d}]" for o in
                       [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0),
                        (0, -1, 0), (0, 0, 1), (0, 0, -1)])

    def bc(v):
        return {"type": "constant", "value": v}
    return {
        "inputs": {
            "a": {"data": "random:0.0,1.0", "data_type": "float32"},
            "b": {"data": "random:0.0,1.0", "data_type": "float32"},
            "ik": {"data": "random:0.0,1.0", "data_type": "float32",
                   "input_dims": ["i", "k"]},
            "sc": {"data": 0.5, "data_type": "float32", "input_dims": []}},
        "outputs": ["s2"], "dimensions": list(dims),
        "program": {
            "s0": {"computation_string":
                   "s0 = a[i,j,k] * a[i,j,k] + 0.1 * a[i,j+1,k]",
                   "boundary_conditions": {"a": bc(0.0)},
                   "data_type": "float32"},
            "s1": {"computation_string":
                   f"s1 = 0.04 * ({box}) + 0.1 * ({cross}) "
                   "+ 0.3 * ik[i,k+1] + sc + 1.0",
                   "boundary_conditions": {"s0": bc(0.2), "b": bc(0.0),
                                           "ik": bc(0.0)},
                   "data_type": "float32"},
            "s2": {"computation_string": "s2 = s1[i,j,k] * 0.5 + "
                   "s1[i-1,j+1,k]",
                   "boundary_conditions": {"s1": bc(0.0)},
                   "data_type": "float32"}}}


def _reconvergent_spec(stages=16, dims=(12, 24, 32)):
    """A deep chain whose last stage reads the first again: one ring far
    deeper than its read count."""
    prog, prev = {}, "a"
    for s in range(stages):
        expr = (f"s{s} = 0.16 * ({prev}[i-1,j,k] + {prev}[i+1,j,k] + "
                f"{prev}[i,j-1,k] + {prev}[i,j+1,k] + {prev}[i,j,k-1] + "
                f"{prev}[i,j,k+1])")
        fields = {prev}
        if s == stages - 1:
            expr += " + 0.1 * s0[i,j,k]"
            fields.add("s0")
        prog[f"s{s}"] = {"computation_string": expr,
                         "boundary_conditions": {
                             f: {"type": "constant", "value": 0.2}
                             for f in fields},
                         "data_type": "float32"}
        prev = f"s{s}"
    return {"inputs": {"a": {"data": "random:-1,1", "data_type": "float32"}},
            "outputs": [prev], "dimensions": list(dims), "program": prog}


class _InputMemo:
    """Each program's inputs made once per phase: ``load_input_arrays``
    (the package's, and the driver's that ``run_program`` calls) served
    from a memo keyed by the program's inputs, dimensions and seed while
    ``on``; a 512^3 input takes seconds to draw on the host, and phases 4,
    5 and 9 draw the same ones for every call.  ``clear()`` drops them."""

    def __init__(self, sft):
        from stencilflow_tpu_torch import driver
        self.modules = (sft, driver)
        self.load = sft.load_input_arrays
        self.memo = {}
        self.on = False
        for m in self.modules:
            m.load_input_arrays = self

    @staticmethod
    def _key(program, prefix, seed):
        return (tuple(program.dimensions), prefix, seed,
                tuple((n, str(s.data), str(s.dtype), tuple(s.dim_mask))
                      for n, s in program.inputs.items()))

    def __call__(self, program, prefix=None, seed: int = 0):
        if not self.on:
            return self.load(program, prefix, seed)
        key = self._key(program, prefix, seed)
        if key not in self.memo:
            self.memo[key] = self.load(program, prefix, seed)
        return dict(self.memo[key])

    def as_bf16(self, program, twin, seed: int = 0):
        """Put ``program``'s inputs (its fields typed bfloat16) in the memo
        made from those of ``twin``, the same program typed float32:
        ``data.load_array`` draws a ``random:`` input in float64, then
        rounds it to float32, then (for bf16) to bf16, so the bf16 draw is
        the float32 one rounded (one pass, where drawing again takes a
        1024^3 input most of a minute on the host).  A no-op when off."""
        from stencilflow_tpu_torch.dtypes import BFLOAT16, cast
        if self.on:
            self.memo[self._key(program, None, seed)] = {
                n: cast(v, BFLOAT16) if np.ndim(v) else v
                for n, v in self(twin, seed=seed).items()}

    def clear(self):
        self.memo.clear()


def _share_bound(program, in_bytes: int, out_bytes: int, share: float,
                 mxu_precision: str = "split"):
    """(bound ms, "bytes" or "operations") of a kernel that evaluates
    ``share`` of ``program``'s cells from ``in_bytes`` of inputs into
    ``out_bytes`` of outputs: the bytes over the data sheet's rate against
    that share of the report's compute bound (the faster strategy; the
    band transforms as single-pass bf16 products under
    ``mxu_precision="bf16"``)."""
    from stencilflow_tpu_torch.report import Report
    rep = Report.build(program)
    t_bytes = (in_bytes + out_bytes) / rep.hw.hbm_bandwidth * 1e3
    t_ops = rep._compute(mxu_precision)[0] * share * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bound(program, mxu_precision: str = "split", compute_dtype=None):
    """(bound ms, "bytes" or "operations") of one chain evaluation: the
    port's report (report.py, the H100 model of config.py), the memory
    floor against the faster compute strategy — one yardstick for this
    script, ``cli report`` and the bench.  ``mxu_precision="bf16"``: the
    band transforms as single-pass bf16 products at the dense bf16
    tensor rate; ``compute_dtype="bfloat16"``: the bytes at 2 a cell."""
    from stencilflow_tpu_torch.report import Report
    rep = Report.build(program)
    return (rep.roofline_time_s(mxu_precision, compute_dtype) * 1e3,
            "bytes" if rep.bound(mxu_precision, compute_dtype) == "hbm"
            else "operations")


def _bf16_plan(sft, pn, gp, st, codegen, kind: str, p, kw):
    """(analysis, plan, source) of a reduced-precision case: bf16 rings
    (``ring_storage="bfloat16"``) unless ``kw`` asks for single-pass bf16
    band passes (``mxu_precision="bf16"``); the group kernel at the main
    path's g = 8, B = 64."""
    an = sft.ChainAnalysis.run(p)
    if kind == "panel":
        plan = pn.PanelPlan.build(an, ring_storage="bfloat16")
        return an, plan, codegen.panel_source(p, an, plan)
    if kind == "group":
        plan = gp.plan_group(p, an, 64, 8, ring_storage="bfloat16")
        return an, plan, codegen.group_source(p, an, plan)
    rings = {} if "mxu_precision" in kw else {"ring_storage": "bfloat16"}
    plan = st.plan_stream(p, an, **kw, **rings)
    return an, plan, st.stream_source(plan)


def _bf16_kernel(pn, gp, st, kind: str, p, an, plan):
    """(run(arrays, lib), plain(arrays), launch count, plan line,
    split(arrays) or None) of a reduced-precision case: ``split`` (single-
    pass bf16 passes only) the plain version of the same program's split
    route, which ``_bf16_held`` holds the kernel apart from."""
    if kind == "panel":
        return (lambda a, lib: pn.run_panel(p, an, plan, a, lib),
                lambda a: pn.panel_plain(p, an, plan, a),
                lambda: pn.launches_by["bf16"],
                f"tile {plan.tile} x {plan.threads}, smem "
                f"{plan.smem_bytes(p)} B, {plan.residency(p)} blocks/SM",
                None)
    if kind == "group":
        return (lambda a, lib: gp.run_group(p, an, plan, a, lib),
                lambda a: gp.group_plain(p, an, plan, a),
                lambda: gp.launches_by["bf16"],
                f"tile {plan.tile} x {plan.threads}, segments "
                f"{plan.segments}, smem {plan.smem_bytes(p)} B, rounded "
                f"{sorted(plan.rounds)}", None)
    line = f"tile {plan.tile} x {plan.threads}, smem {plan.smem_bytes()} B"
    if plan.packed:
        line += (f", spilled {len(plan.spilled)} of {len(plan.raw_ring)} "
                 f"rings ({plan.spill_bytes() / 2 ** 30:.3f} GiB)")
    if plan.tkeys:
        line += f", {_routes(plan)} passes"
    split = None
    if plan.mxu_precision == "bf16":
        split_plan = st.plan_stream(p, an)
        split = lambda a: st.stream_plain(split_plan, a)  # noqa: E731
    return (lambda a, lib: st.run_stream(plan, a, lib),
            lambda a: st.stream_plain(plan, a),
            lambda: (st.launches_by["spill_bf16"] if plan.packed
                     else st.launches_by["bf16"]),
            line, split)


def _bf16_held(got, plain, split):
    """(ok, max abs err against the plain version, the figures of
    ``stream.bf16_passes_agree`` or None) of a reduced-precision kernel's
    output: finite and, for bf16 rings (``split`` None), bit for bit; for
    single-pass bf16 passes, ``bf16_passes_agree`` against the plain
    version and ``split`` (the split route's output)."""
    from stencilflow_tpu_torch.backend.stream import bf16_passes_agree
    got = np.asarray(got).reshape(np.shape(plain))
    if split is None:
        ok, err = _compare(got, plain, 0.0)
        return ok and bool(np.isfinite(got).all()), err, None
    ok, fig = bf16_passes_agree(plain, got, split)
    return ok, fig["max_abs_err"], fig


def _held_text(fig) -> str:
    """How a reduced-precision kernel was held (``_bf16_held``)."""
    if fig is None:
        return "(bit-exact)"
    return (f"({fig['share']:.4%} of cells within BF16_PASS_RTOL, the "
            f"rest within BF16_VERIFY_RTOL; at that share "
            f"{fig['plain_q']:.3g} from it, {fig['split_q']:.3g} from "
            "split)")


def _bf16_legs(sft, pn, gp, st, run_program, compile_chain_rows, bf16_main,
               bf16_plain, f32_route, report, smi, cells):
    """Phase 4's reduced-precision legs at full width, the counts set to 0
    just before and read just after: jacobi3d 512^3 x 8 ``run --backend
    panel --ring-storage bfloat16`` (K1), jacobi3d 512^3 x 32 ``--backend
    stream --ring-storage bfloat16`` (K3c), jacobi2d 8192^2 x 8 through
    ``compile_chain_rows(p, "group", group=8, panel=64,
    ring_storage="bfloat16")`` (K5: ``run --backend rows --ring-storage``
    takes rows+stream, as the JAX package's does) and box3d 256^3 x 8 of
    extent 2 ``--backend stream --mxu-precision bf16`` (K3b).  Each leg's
    output is held to its mode's plain version on the same inputs
    (computed before the main path, ``_bf16_held``: bf16 rings bit for
    bit, bf16 passes by ``bf16_passes_agree`` against it and the f32
    route), and its largest difference from its cell's f32 route (phase
    4's main path) is printed beside both times, with the plain version's
    own.  Every leg must lie within BF16_VERIFY_RTOL of its f32 route,
    the JAX package's envelope for these modes, wherever its plain
    version does: the one rule for all legs.  Where the plain version
    itself lies outside (bf16 rings round once a stage, and a deep chain
    on a large grid drifts past the envelope, as the JAX package's own
    mode does: tests/test_torch_bf16.py holds the two equal at 32
    stages), the kernel, equal to it, is outside by the mode's drift, and
    the line says so."""
    import torch
    from stencilflow_tpu_torch.config import BF16_VERIFY_RTOL
    from stencilflow_tpu_torch.data import arrays_are_equal

    def rel(a, want):
        return float(np.max(np.abs(np.asarray(a, np.float64).reshape(
            want.shape) - want)) / np.max(np.abs(want)))
    jacobi8, jacobi32, jacobi2d, box256 = cells
    pn.launches_by["bf16"] = gp.launches_by["bf16"] = 0
    st.launches_by["bf16"] = st.launches_by["spill_bf16"] = 0
    legs = (("panel_bf16", jacobi8, "--backend panel --ring-storage "
             "bfloat16", dict(backend="panel", ring_storage="bfloat16"), 20),
            ("stream_spill_bf16", jacobi32, "--backend stream "
             "--ring-storage bfloat16", dict(backend="stream",
                                             ring_storage="bfloat16"), 3),
            ("group_bf16", jacobi2d, "compile_chain_rows(group=8, panel=64, "
             "ring_storage=bfloat16)", None, 20),
            ("stream_bf16", box256, "--backend stream --mxu-precision bf16",
             dict(backend="stream", mxu_precision="bf16"), 20))
    for key, p, spelled, kw, reps in legs:
        o = p.outputs[0]
        if kw is None:
            fn, backend = compile_chain_rows(p, "group", group=8, panel=64,
                                             device="cuda",
                                             ring_storage="bfloat16")
            inputs = {k: v if p.inputs[k].is_scalar else
                      torch.as_tensor(np.asarray(v)).cuda()
                      for k, v in sft.load_input_arrays(p, seed=0).items()}
            out = fn(inputs)[o].cpu().numpy()
            ms = _time_ms(lambda: fn(inputs), reps)
            del fn, inputs
        else:
            res = run_program(p, device="cuda", repetitions=reps,
                              save_results=False, log_level=0, **kw)
            out, backend, ms = (res.outputs[o], res.backend,
                                res.wall_time_s * 1e3)
            del res
        want, route, route_ms = f32_route[p.name]
        *_, line, split = _bf16_kernel(pn, gp, st, *bf16_main[key][:4])
        plain = bf16_plain[key].reshape(want.shape)
        same, err, fig = _bf16_held(out, plain, want if split else None)
        within = arrays_are_equal(want, out.reshape(want.shape),
                                  BF16_VERIFY_RTOL)
        drift = rel(out, want)
        # the plain version's own (the same arrays where the leg equals it)
        mode_within, mode_drift = (within, drift) if err == 0 else (
            arrays_are_equal(want, plain, BF16_VERIFY_RTOL), rel(plain, want))
        print(f"main: {p.name} {spelled}: backend {backend} {ms:.3f} ms "
              f"({p.total_elements / ms / 1e6:.2f} GCell/s) | f32 route "
              f"{route} {route_ms:.3f} ms | its plain version: max_abs_err "
              f"{err:.3g} {'OK' if same else 'MISMATCH'} "
              f"{_held_text(fig)} | from f32: max diff "
              f"{drift:.3g} of the largest output "
              f"({'within' if within else 'OUTSIDE'} BF16_VERIFY_RTOL), "
              f"its plain version's {mode_drift:.3g} "
              f"({'within' if mode_within else 'OUTSIDE: the mode'}) | "
              f"{line} | {smi}", flush=True)
        if not same:
            raise RuntimeError(f"{p.name}: the {key} leg disagrees with its "
                               "plain version")
        if not within and mode_within:
            raise RuntimeError(f"{p.name}: the {key} leg is not within "
                               "BF16_VERIFY_RTOL of its f32 route")
        del out
        torch.cuda.empty_cache()
    report["panel_bf16"]["launches"] = pn.launches_by["bf16"]
    report["group_bf16"]["launches"] = gp.launches_by["bf16"]
    report["stream_spill_bf16"]["launches"] = st.launches_by["spill_bf16"]
    report["stream_bf16"]["launches"] = st.launches_by["bf16"]
    if st.launches_by["spill_bf16"] != 4:
        raise RuntimeError(f"the bf16 spill leg launched K3c "
                           f"{st.launches_by['spill_bf16']} times over 4 "
                           "calls")


def _compute_bf16_legs(sft, st, cbf_main, lib_of, smi):
    """Phase 4's narrow-compute legs at full width (``compile_chain_stream(
    compute_dtype=...)``, the plan's type): jacobi3d 512^3 x 8 (K3a) and
    box3d 256^3 x 8 of extent 2 (K3b, its composed bands on tensor cores)
    in bf16, jacobi3d 512^3 x 8 (K3a) in float16.  Each
    cell's kernel against its plain version on the same inputs
    (``stream.bf16_compute_agree``: bit for bit per cell, the banded rule
    banded), then timed in turns with the f32 stream kernel on the same
    tile where that plan fits (f32, bf16, bf16, f32), its drift from f32
    (the largest difference over the largest output) and one chained
    ``F.conv3d`` in the compute type over the domain (the library
    yardstick); then the leg itself through the entry point, the count set
    to 0 just before and read just after (one launch a call).  Returns the
    kernels line's entries."""
    import torch
    from stencilflow_tpu_torch.dtypes import to_torch_dtype
    out = {}
    for key, (p, plan, f32) in cbf_main.items():
        o = p.outputs[0]
        cd = plan.compute_dtype
        count = st.compute_key(plan)
        lib, flib = (lib_of[st.stream_source(q)] for q in (plan, f32))
        arrays = _spanned_on_card(sft, p)
        got = st.run_stream(plan, arrays, lib)[o]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = st.stream_plain(plan, arrays)[o]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        banded = bool(plan.mxu_plans)
        ok, fig = st.bf16_compute_agree(want.cpu().numpy(),
                                        got.cpu().numpy(), banded)
        ref = st.run_stream(f32, arrays, flib)[o].cpu().numpy()
        drift = float(np.max(np.abs(got.cpu().numpy().astype(np.float64)
                                    - ref)) / np.max(np.abs(ref)))
        del got, want, ref
        turns = [_time_ms(lambda q=q, lb=lb: st.run_stream(q, arrays, lb), 5)
                 for q, lb in ((f32, flib), (plan, lib), (plan, lib),
                               (f32, flib))]
        ms, f32_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        del arrays
        radius = 2 if banded else 1
        lib_ms = _conv_chain_ms(p, radius, dtype=to_torch_dtype(
            plan.compute_narrow))
        bound_ms, bound_by = _bound(p, compute_dtype=cd)
        # the leg through the entry point (a lookup of the built kernel)
        fn = st.compile_chain_stream(p, compute_dtype=cd)
        inputs = {k: v if p.inputs[k].is_scalar else
                  torch.as_tensor(np.asarray(v)).cuda()
                  for k, v in sft.load_input_arrays(p, seed=0).items()}
        st.launches_by[count] = 0
        leg = fn(inputs)[o]
        torch.cuda.synchronize()
        launches = st.launches_by[count]
        same = bool(torch.equal(leg, st.run_stream(plan, _spanned_on_card(
            sft, p), lib)[o].reshape(leg.shape)))
        del leg, inputs, fn
        plan.device_pool.clear()
        f32.device_pool.clear()
        torch.cuda.empty_cache()
        print(f"kernel: {key} {p.name} compute_dtype={cd} tile "
              f"{plan.tile} x {plan.threads}, smem {plan.smem_bytes()} B "
              f"(f32 tile {f32.tile}, {f32.smem_bytes()} B)"
              f"{', ' + _routes(plan) + ' passes' if banded else ''}: "
              f"{ms:.3f} ms (in turns {turns[1]:.3f} / {turns[2]:.3f}) | "
              f"f32 stream kernel {f32_ms:.3f} ms (in turns {turns[0]:.3f} "
              f"/ {turns[3]:.3f}) | plain version {plain_ms:.1f} ms, "
              f"max_abs_err {fig['max_abs_err']:.3g}, {fig['share']:.4%} of "
              f"cells equal, {'OK' if ok else 'MISMATCH'} | drift from f32 "
              f"{drift:.3g} of the largest output | bound {bound_ms:.4f} ms "
              f"({bound_by}) | {len(p.kernels)} chained F.conv3d in {cd} "
              f"{lib_ms:.3f} ms | leg: compile_chain_stream launches "
              f"{launches}, equal to the kernel: {'yes' if same else 'NO'} "
              f"| {smi}", flush=True)
        if not ok or not same or launches != 1:
            raise RuntimeError(f"{key}: the {cd}-compute kernel disagrees "
                               f"with its plain version ({fig}) or its leg "
                               f"(launches {launches})")
        out[key] = {"name": key, "route": "cuda",
                    "source": "stencilflow_tpu_torch/backend/codegen.py",
                    "replaces": "stencilflow_tpu/backend/stream.py:1683",
                    "launches": launches, "max_abs_err": fig["max_abs_err"],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms}
    return out


# compute types of programs typed other than float32, and int32 and bool
# compute (compile_chain_stream(compute_dtype=...)): the kernels line's
# row of each new launch key, from its phase
COMPUTE_ROWS = {"compute_f32_typed": 4, "compute_i32": 4,
                "compute_bf16_typed": 4, "compute_f16_typed": 3,
                "compute_bool": 3}


def _ct_setup(sft, st, synthesize_stencil):
    """Phase 2's share of the compute-type legs: phase 3's small cases
    (float32, bf16 and f16 compute on the mixed-type chain and on the
    bf16 chain with an int32 stage, int32 and bool compute on jacobi3d
    64^3 x 3 on [-1000, 1000), each as K3a and as K3c, spill="all"), then
    phase 4's three full-width K3a cells (jacobi3d 512^3 x 8 typed bf16
    under f32 compute, jacobi3d 512^3 x 8 on [-1000, 1000) under int32,
    the mixed-type chain at the largest cube up to 512^3 whose plan fits
    under bf16), each with its yardstick plan: the same program's f32
    compute (under f32 compute: its own types), on the same tile where
    that plan fits.  Returns (small, mains, sources)."""
    from stencilflow_tpu_torch.synthesize import (mixed_dtype_spec,
                                                  narrow_mixed_spec)

    def jac(n, iters, **kw):
        return sft.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=(n,) * 3, shape="diffusion",
            **kw), name=f"jacobi3d_{n}_{iters}itr"
            + ("_wide" if "random:-1000" in kw.get("seed_data", "") else "")
            + ("_" + kw["data_type"] if "data_type" in kw else ""))

    def yardstick(p, plan, cd, kw):
        other = None if cd == "float32" else "float32"
        try:
            return st.plan_stream(p, compute_dtype=other, tile=plan.tile,
                                  **kw)
        except ValueError:
            return st.plan_stream(p, compute_dtype=other, **kw)

    small_dims = (24, 40, 72)
    mixed = sft.parse_program(mixed_dtype_spec(small_dims)[0],
                              name="mixed_dtype_small")
    narrow = sft.parse_program(narrow_mixed_spec(small_dims),
                               name="narrow_mixed_small")
    wide = jac(64, 3, seed_data="random:-1000,1000")
    small, sources = [], []
    for label, p, cds in (("mixed", mixed, ("float32", "bfloat16",
                                            "float16")),
                          ("narrow", narrow, ("float32", "bfloat16",
                                              "float16")),
                          ("jacobi3d-64", wide, ("int32", "bool"))):
        for cd in cds:
            for kernel, kw in (("K3a", {}), ("K3c", {"spill": "all"})):
                plan = st.plan_stream(p, compute_dtype=cd, **kw)
                other = yardstick(p, plan, cd, kw)
                small.append((f"{kernel} {label} {cd}", p, plan, other))
                sources += [(st.stream_source(q), "stream")
                            for q in (plan, other)]
    mains = {}
    bf_jac = jac(512, 8, seed_data="random:0.0,1.0", data_type="bfloat16")
    wide512 = jac(512, 8, seed_data="random:-1000,1000")
    for key, p, cd in (("stream_compute_f32_typed", bf_jac, "float32"),
                       ("stream_compute_i32", wide512, "int32")):
        plan = st.plan_stream(p, compute_dtype=cd)
        mains[key] = (p, plan, yardstick(p, plan, cd, {}), cd)
    for n in (512, 448, 384, 320, 256):
        p = sft.parse_program(mixed_dtype_spec((n,) * 3)[0],
                              name=f"mixed_dtype_{n}")
        try:
            plan = st.plan_stream(p, compute_dtype="bfloat16")
        except ValueError:
            continue
        mains["stream_compute_bf16_typed"] = (
            p, plan, yardstick(p, plan, "bfloat16", {}), "bfloat16")
        break
    for p, plan, other, _cd in mains.values():
        sources += [(st.stream_source(q), "stream") for q in (plan, other)]
    return small, mains, sources


def _ct_library(p, cd):
    """(library ms or None, its text): chained F.conv3d in the compute
    type where a library call computes the chain (a linear one) and
    cuDNN takes the type."""
    import torch
    from stencilflow_tpu_torch.backend.linear import extract_linear
    linear = all(extract_linear(k) is not None for k in p.kernels.values())
    if not linear:
        return None, "none (no library call computes this nonlinear chain)"
    if cd in ("int32", "bool"):
        return None, f"none (cuDNN takes no {cd} convolution)"
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}[cd]
    ms = _conv_chain_ms(p, 1, dtype=dt)
    return ms, f"{len(p.kernels)} chained F.conv3d in {cd} {ms:.4f} ms"


def _ct_compare(st, p, got, want):
    """(ok, max abs err, how) of a compute-type kernel against its plain
    version: bit for bit (NaN == NaN), within VERIFY_RTOL where a
    transcendental meets float32 compute (libdevice against torch's own
    on the card)."""
    import torch
    from stencilflow_tpu_torch.config import VERIFY_RTOL
    rtol = VERIFY_RTOL if _has_transcendental(p) else 0.0
    ok, err = True, 0.0
    for o in p.outputs:
        g, w = got[o], want[o]
        if g.dtype == torch.bfloat16:
            g, w = g.float(), w.float()
        a, b = g.cpu().numpy(), w.cpu().numpy()
        k, e = _compare(a, b, rtol)
        ok, err = ok and k, max(err, e)
    return ok, err, "bit-exact" if rtol == 0 or err == 0 else "VERIFY_RTOL"


def _ct_small(sft, st, small, lib_of, smi):
    """Phase 3's compute-type legs: each kernel on the card against its
    plain version, timed in turns with its yardstick plan (the same
    program's f32 compute, or under f32 compute its own types), beside
    the plain version's ms, the bound and the library call.  Each key's
    count is set to 0 before the first leg and read after the last.
    Returns the kernels line's rows of the keys phase 4 does not run."""
    import torch
    from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
    t0 = time.perf_counter()
    keys = {st.compute_key(plan) for _l, _p, plan, _o in small}
    for key in keys:
        st.launches_by[key] = 0
    rows = {}
    for label, p, plan, other in small:
        key = st.compute_key(plan)
        lib, olib = (lib_of[st.stream_source(q)] for q in (plan, other))
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=7),
                                device="cuda")
        before = st.launches_by[key]
        got = st.run_stream(plan, arrays, lib)
        torch.cuda.synchronize()
        n = st.launches_by[key] - before
        t1 = time.perf_counter()
        want = st.stream_plain(plan, arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        ok, err, how = _ct_compare(st, p, got, want)
        saved = dict(st.launches_by)
        turns = [_time_ms(lambda q=q, lb=lb: st.run_stream(q, arrays, lb), 5)
                 for q, lb in ((other, olib), (plan, lib), (plan, lib),
                               (other, olib))]
        st.launches_by.clear()
        st.launches_by.update(saved)   # timing launches are not counted
        ms, o_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        bound_ms, bound_by = _bound(p, compute_dtype=plan.compute_dtype)
        lib_ms, lib_text = _ct_library(p, plan.compute_dtype)
        yard = ("its own types" if plan.compute_dtype == "float32"
                else "f32 compute")
        print(f"compare: ctype   {label:28s} {key} tile {plan.tile} x "
              f"{plan.threads} smem {plan.smem_bytes()} B"
              f"{' spilled %d rings' % len(plan.spilled) if plan.packed else ''}"
              f" max_abs_err {err:.3g} launches {n} "
              f"{'OK' if ok else 'MISMATCH'} ({how}) | {ms:.4f} ms (in "
              f"turns {turns[1]:.4f} / {turns[2]:.4f}), {yard} {o_ms:.4f} "
              f"ms | plain version {plain_ms:.1f} ms | bound "
              f"{bound_ms:.4f} ms ({bound_by}) | library {lib_text} | {smi}",
              flush=True)
        if not ok or n != 1:
            raise RuntimeError(f"compute-type stream kernel ({label}) "
                               "disagrees with its plain version")
        if COMPUTE_ROWS.get(key) == 3 and not (key in rows
                                               or plan.packed):
            rows[key] = {"name": "stream_" + key, "route": "cuda",
                         "source": "stencilflow_tpu_torch/backend/codegen.py",
                         "replaces": "stencilflow_tpu/backend/stream.py:1683",
                         "launches": 0, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib_ms}
        del got, want, arrays
    for key in rows:
        rows[key]["launches"] = st.launches_by[key]
    for key in keys:
        if not st.launches_by[key]:
            raise RuntimeError(f"phase 3 launched no {key} kernel")
    print(f"ctype: phase 3's legs took {time.perf_counter() - t0:.1f} s | "
          f"{smi}", flush=True)
    return {"stream_" + k: v for k, v in rows.items()}


def _ct_legs(sft, st, mains, lib_of, smi):
    """Phase 4's compute-type cells at full width (K3a): each kernel
    against its plain version on the same inputs, timed in turns with its
    yardstick plan, the plain version's ms, the bound and the library
    call; then the cell through ``compile_chain_stream`` with its count
    set to 0 just before and read just after (one launch), equal to the
    kernel.  Returns the kernels line's rows."""
    import torch
    from stencilflow_tpu_torch.dtypes import to_torch
    out = {}
    t0 = time.perf_counter()
    for name, (p, plan, other, cd) in mains.items():
        key = st.compute_key(plan)
        lib, olib = (lib_of[st.stream_source(q)] for q in (plan, other))
        arrays = _spanned_on_card(sft, p)
        got = st.run_stream(plan, arrays, lib)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = st.stream_plain(plan, arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        ok, err, how = _ct_compare(st, p, got, want)
        del got, want
        turns = [_time_ms(lambda q=q, lb=lb: st.run_stream(q, arrays, lb), 5)
                 for q, lb in ((other, olib), (plan, lib), (plan, lib),
                               (other, olib))]
        ms, o_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        del arrays
        bound_ms, bound_by = _bound(p, compute_dtype=cd)
        lib_ms, lib_text = _ct_library(p, cd)
        fn = st.compile_chain_stream(p, compute_dtype=cd)
        inputs = {k: v if p.inputs[k].is_scalar else to_torch(v, "cuda")
                  for k, v in sft.load_input_arrays(p, seed=0).items()}
        st.launches_by[key] = 0
        leg = fn(inputs)
        torch.cuda.synchronize()
        launches = st.launches_by[key]
        direct = st.run_stream(plan, _spanned_on_card(sft, p), lib)
        same = all(torch.equal(leg[o], direct[o].reshape(leg[o].shape))
                   for o in p.outputs)
        del leg, direct, inputs, fn
        plan.device_pool.clear()
        other.device_pool.clear()
        torch.cuda.empty_cache()
        yard = ("its own types" if cd == "float32" else "f32 compute")
        print(f"kernel: {name} {p.name} compute_dtype={cd} ({key}) tile "
              f"{plan.tile} x {plan.threads}, smem {plan.smem_bytes()} B "
              f"({yard}: tile {other.tile}, {other.smem_bytes()} B): "
              f"{ms:.3f} ms (in turns {turns[1]:.3f} / {turns[2]:.3f}) | "
              f"{yard} {o_ms:.3f} ms (in turns {turns[0]:.3f} / "
              f"{turns[3]:.3f}) | plain version {plain_ms:.1f} ms, "
              f"max_abs_err {err:.3g} {'OK' if ok else 'MISMATCH'} ({how}) "
              f"| bound {bound_ms:.4f} ms ({bound_by}) | library {lib_text} "
              f"| leg: compile_chain_stream launches {launches}, equal to "
              f"the kernel: {'yes' if same else 'NO'} | {smi}", flush=True)
        if not ok or not same or launches != 1:
            raise RuntimeError(f"{name}: the {cd}-compute kernel disagrees "
                               f"with its plain version or its leg "
                               f"(launches {launches})")
        out[name] = {"name": name, "route": "cuda",
                     "source": "stencilflow_tpu_torch/backend/codegen.py",
                     "replaces": "stencilflow_tpu/backend/stream.py:1683",
                     "launches": launches, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms}
    print(f"ctype: phase 4's cells took {time.perf_counter() - t0:.1f} s | "
          f"{smi}", flush=True)
    return out


def _spanned_on_card(sft, p):
    """``p``'s inputs (seed 0) at their spanned shapes on the card."""
    from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
    return spanned_arrays(p, sft.load_input_arrays(p, seed=0), device="cuda")


def _conv_chain_ms(program, radius: int, shape=None, dtype=None) -> float:
    """One ``F.conv3d`` (``F.conv2d`` for a 2-D program) per stage,
    chained, computing the same constant-0 linear chain with TF32 off over
    the program's domain (or ``shape``), in float32 or ``dtype``: the
    library yardstick (timed only; the port never calls it).  The stages
    of these chains are identical, so the first stage's coefficients give
    the filter."""
    import torch
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    from stencilflow_tpu_torch.backend.linear import extract_linear
    stages = list(program.kernels.values())
    nd = len(program.raw_dimensions)
    w = np.zeros((1, 1) + (2 * radius + 1,) * nd, np.float32)
    for key, c in extract_linear(stages[0]).items():
        if key != ("const",):
            w[(0, 0) + tuple((o or 0) + radius
                             for o in key[1][3 - nd:])] = c
    weight = torch.as_tensor(w, device="cuda").to(dtype or torch.float32)
    x = torch.rand((1, 1) + tuple(shape or program.raw_dimensions),
                   device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0)).to(
                       dtype or torch.float32)
    conv = F.conv3d if nd == 3 else F.conv2d

    def run():
        y = x
        for _ in stages:
            y = conv(y, weight, padding=radius)
        return y
    return _time_ms(run, 3)


def _link_rates():
    """(host-to-device, device-to-host) bytes/s of 1 GiB ``copy_``s
    between pinned host memory and the card."""
    import torch
    n = 1 << 28
    host = torch.empty(n, dtype=torch.float32, pin_memory=True)
    dev = torch.empty(n, dtype=torch.float32, device="cuda")
    up = _time_ms(lambda: dev.copy_(host, non_blocking=True), 3)
    down = _time_ms(lambda: host.copy_(dev, non_blocking=True), 3)
    del host, dev
    torch.cuda.empty_cache()
    return 4 * n / up * 1e3, 4 * n / down * 1e3


def _fuzz_chunked(cases):
    """(label, program, chunks): the 3-D fuzz chain of phase 3 drawn again
    at (48, 20, 24), with the most chunks (of 4, 3, 2) its i-halo allows."""
    import stencilflow_tpu_torch as sft
    from stencilflow_tpu_torch.backend.dense import chain_halo
    from stencilflow_tpu_torch.synthesize import random_program
    label = next(lb for lb, _p in cases
                 if lb.rsplit("-", 1)[0] == "fuzz-f32")
    spec = random_program(np.random.default_rng(int(label.rsplit("-", 1)[1])),
                          ndim=3)
    spec["dimensions"] = [48, 20, 24]
    p = sft.parse_program(spec, name="fuzz_f32_chunked")
    h = chain_halo(sft.ChainAnalysis.run(p))[0]
    chunks = next(c for c in (4, 3, 2) if h < 48 // c)
    return f"{label.rsplit('-', 1)[0]}-48", p, chunks


def _outofcore(sft, st, pn, ov, gp, oc_cells, oc_plans, lib_of, smi,
               run_program):
    """Phase 5: K4 alone on one jacobi chunk, then each out-of-core cell
    against the in-core route.  Returns K4's entry of the kernels line."""
    import torch
    from stencilflow_tpu_torch import outofcore
    from stencilflow_tpu_torch.cardcheck import chunk_slabs
    from stencilflow_tpu_torch.report import Report
    up_rate, down_rate = _link_rates()
    print(f"link: pinned host-to-device {up_rate / 1e9:.2f} GB/s, "
          f"device-to-host {down_rate / 1e9:.2f} GB/s (1 GiB copy_) | {smi}",
          flush=True)

    # K4 alone at the main path's shapes: the middle chunk of jacobi 1024^3
    p, chunks = oc_cells[0]
    plan = oc_plans[p.name]
    lib = lib_of[st.stream_source(plan)]
    _, J, K = p.dimensions
    c = chunks // 2
    lo = c * plan.block - plan.halo_i
    inputs = sft.load_input_arrays(p, seed=0)
    slabs = chunk_slabs(p, inputs, lo, plan.extent())
    del inputs
    got = st.run_local_stream(plan, lo, slabs, lib)
    torch.cuda.synchronize()
    t_plain = time.perf_counter()
    want = st.local_stream_plain(plan, lo, slabs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t_plain) * 1e3
    ok, err = _compare(got[p.outputs[0]].cpu().numpy(),
                       want[p.outputs[0]].cpu().numpy(), 0.0)
    del got, want
    ms = _time_ms(lambda: st.run_local_stream(plan, lo, slabs, lib), 10)
    chunk_bytes = sum(t.numel() * t.element_size() for n, t in slabs.items()
                      if not p.inputs[n].is_scalar)
    chunk_bytes += sum(plan.block * J * K * np.dtype(p.kernels[o].dtype)
                       .itemsize for o in p.outputs)
    rep = Report.build(p)
    t_bytes = chunk_bytes / rep.hw.hbm_bandwidth * 1e3
    t_ops = rep.alu_time_s() * plan.block / p.dimensions[0] * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    del slabs
    torch.cuda.empty_cache()
    lib_ms = _conv_chain_ms(p, 1, shape=(plan.extent(), J, K))
    torch.cuda.empty_cache()
    print(f"kernel: local_stream {p.name} chunk {c} of {chunks} "
          f"({plan.extent()} planes in, {plan.block} out) tile {plan.tile} "
          f"x {plan.threads} threads, smem {plan.smem_bytes()} B packed "
          f"(unpacked {plan.unpacked_bytes()}), {pn.occupancy(lib)} blocks "
          f"per SM, {plan.evaluations():.2f} evaluations a cell, passes "
          f"{_routes(plan) or 'none (per cell)'}: {ms:.3f} ms per chunk, plain "
          f"version {plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}),"
          f" {len(p.kernels)} chained F.conv3d over the widened chunk "
          f"{lib_ms:.3f} ms, max_abs_err {err:.3g} "
          f"{'OK' if ok else 'MISMATCH'} | {smi}", flush=True)
    if not ok:
        raise RuntimeError("local stream kernel disagrees with its plain "
                           f"version on {p.name}")
    entry = {"name": "local_stream", "route": "cuda",
             "source": "stencilflow_tpu_torch/backend/codegen.py",
             "replaces": "stencilflow_tpu/backend/stream.py:1735",
             "launches": 0, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": lib_ms}

    reps = 2
    for p, chunks in oc_cells:
        res = run_program(p, device="cuda", repetitions=reps,
                          save_results=False, log_level=0)
        if res.backend != "panel":
            raise RuntimeError(f"{p.name}: in-core backend {res.backend}, "
                               "expected panel")
        in_core, in_ms = res.outputs, res.wall_time_s * 1e3
        del res
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for m in (pn, ov, st, gp):
            m.launches_by["exact"] = 0
        st.launches_by["local"] = 0
        oc = run_program(p, device="cuda", host_chunks=chunks,
                         repetitions=reps, save_results=False, log_level=0)
        n = st.launches_by["local"]
        other = sum(m.launches_by["exact"] for m in (pn, ov, st, gp))
        peak = torch.cuda.max_memory_allocated()
        stats = oc.host_staging
        label = f"outofcore[stream x{chunks} chunks]"
        if oc.backend != label:
            raise RuntimeError(f"{p.name}: backend {oc.backend}, expected "
                               f"{label}")
        if n != chunks * (reps + 1) or other:
            raise RuntimeError(f"{p.name}: K4 launched {n} times over "
                               f"{reps + 1} calls of {chunks} chunks "
                               f"(other kernels {other})")
        for o in p.outputs:
            if not np.array_equal(oc.outputs[o], in_core[o]):
                raise RuntimeError(f"{p.name}: out-of-core output {o} "
                                   "differs from the in-core route")
        up, down = outofcore.link_bytes(p, outofcore.ChunkPlan(
            chunks, oc_plans[p.name].block, oc_plans[p.name].halo_i,
            "stream", {}))
        duplex = max(up / up_rate, down / down_rate) * 1e3
        serial = (up / up_rate + down / down_rate) * 1e3
        io = Report.build(p).hbm_footprint_bytes()
        cells = p.total_elements
        print(f"outofcore: {p.name} {oc.backend} {oc.wall_time_s * 1e3:.3f} "
              f"ms per call (CUDA events over {reps} calls, transfers "
              f"included; {cells / oc.wall_time_s / 1e9:.2f} GCell/s) | "
              f"in-core panel {in_ms:.3f} ms (transfers excluded) | equal "
              f"to in-core | K4 launches {n} over {reps + 1} calls | link "
              f"{up / 2 ** 30:.3f} GiB up + {down / 2 ** 30:.3f} GiB down, "
              f"bound {duplex:.3f} ms both ways at once, {serial:.3f} ms "
              f"one after the other | host slab fill "
              f"{stats['fill_s'] * 1e3:.1f} ms, drain "
              f"{stats['drain_s'] * 1e3:.1f} ms (last call) | device peak "
              f"{peak / 2 ** 30:.3f} GiB, in-core in+out "
              f"{io / 2 ** 30:.3f} GiB | {smi}", flush=True)
        if p is oc_cells[0][0] and peak >= io / 3:
            raise RuntimeError(f"{p.name}: device peak {peak} B is not "
                               f"below a third of {io} B")
        entry["launches"] += n
        del oc, in_core
        torch.cuda.empty_cache()
    return entry


def _counts_zero(pn, ov, gp, tl, st):
    """Every kernel's launch count set to 0."""
    for m in (pn, ov, gp, tl, st):
        m.launches_by.clear()


def _counts(pn, ov, gp, tl, st) -> dict:
    """Every kernel's launch count that is not 0, keyed "module:mode"."""
    return {f"{m.__name__.rsplit('.', 1)[1]}:{mode}": n
            for m in (pn, ov, gp, tl, st)
            for mode, n in m.launches_by.items() if n}


def _rel(a, want) -> float:
    """Largest difference of ``a`` from ``want`` over ``want``'s largest
    magnitude."""
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(a, np.float64).reshape(
        want.shape) - want)) / np.max(np.abs(want)))


def _outofcore_bf16(sft, st, pn, ov, gp, tl, p, chunks, plans, lib_of, smi,
                    run_program):
    """Phase 5, continued: K4's single-pass bf16 band passes in chunk mode
    (``run --host-chunks N --mxu-precision bf16``) on box3d 512^3 x 8 of
    extent 2 at ``chunks`` chunks.  K4 alone on the middle chunk against
    its plain version (``_bf16_held``: ``bf16_passes_agree`` against it
    and the split chunk plan's plain version) and timed in turns with the
    split chunk kernel (split, bf16, bf16, split); then the out-of-core
    call, the counts set to 0 just before and read just after (K4's bf16
    launches: chunks a call, nothing else launched), its output within
    BF16_VERIFY_RTOL of the in-core f32 route's on the same inputs.
    Returns its entry of the kernels line."""
    import torch
    from stencilflow_tpu_torch.cardcheck import chunk_slabs
    from stencilflow_tpu_torch.config import BF16_VERIFY_RTOL
    from stencilflow_tpu_torch.data import arrays_are_equal
    plan, split_plan = plans
    lib = lib_of[st.stream_source(plan)]
    slib = lib_of[st.stream_source(split_plan)]
    _, J, K = p.dimensions
    o = p.outputs[0]
    c = chunks // 2
    lo = c * plan.block - plan.halo_i
    slabs = chunk_slabs(p, sft.load_input_arrays(p, seed=0), lo,
                         plan.extent())
    before = st.launches_by["local_bf16"]
    got = st.run_local_stream(plan, lo, slabs, lib)
    torch.cuda.synchronize()
    counted = st.launches_by["local_bf16"] - before
    t_plain = time.perf_counter()
    want = st.local_stream_plain(plan, lo, slabs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t_plain) * 1e3
    far = st.local_stream_plain(split_plan, lo, slabs)[o].cpu().numpy()
    ok, err, fig = _bf16_held(got[o].cpu().numpy(), want[o].cpu().numpy(),
                              far)
    del got, want, far
    turns = [_time_ms(lambda q=q, lb=lb: st.run_local_stream(
        q, lo, slabs, lb), 5) for q, lb in ((split_plan, slib), (plan, lib),
                                            (plan, lib), (split_plan, slib))]
    ms, f32_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    in_bytes = sum(t.numel() * t.element_size() for n, t in slabs.items()
                   if not p.inputs[n].is_scalar)
    out_bytes = sum(plan.block * J * K * np.dtype(p.kernels[q].dtype)
                    .itemsize for q in p.outputs)
    bound_ms, bound_by = _share_bound(p, in_bytes, out_bytes,
                                      plan.block / p.dimensions[0], "bf16")
    del slabs
    torch.cuda.empty_cache()
    print(f"kernel: local_stream_bf16 {p.name} chunk {c} of {chunks} "
          f"({plan.extent()} planes in, {plan.block} out) tile {plan.tile} "
          f"x {plan.threads}, smem {plan.smem_bytes()} B, banded "
          f"{sorted(plan.mxu_plans)}, {_routes(plan)} bf16 passes: "
          f"{ms:.3f} ms per chunk (in turns {turns[1]:.3f} / "
          f"{turns[2]:.3f}) | the split chunk kernel tile {split_plan.tile} "
          f"x {split_plan.threads}, {_routes(split_plan)} passes {f32_ms:.3f}"
          f" ms (in turns {turns[0]:.3f} / {turns[3]:.3f}) | plain version "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"max_abs_err {err:.3g} {'OK' if ok else 'MISMATCH'} "
          f"{_held_text(fig)} | {smi}", flush=True)
    if not ok or counted != 1:
        raise RuntimeError(f"K4's bf16 passes disagree with their plain "
                           f"version on {p.name} (launches {counted})")
    entry = {"name": "local_stream_bf16", "route": "cuda",
             "source": "stencilflow_tpu_torch/backend/codegen.py",
             "replaces": "stencilflow_tpu/backend/stream.py:1943",
             "launches": 0, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None}

    reps = 2
    res = run_program(p, device="cuda", repetitions=reps,
                      save_results=False, log_level=0)
    f32_out, route, route_ms = (res.outputs[o], res.backend,
                                res.wall_time_s * 1e3)
    del res
    torch.cuda.empty_cache()
    _counts_zero(pn, ov, gp, tl, st)
    oc = run_program(p, device="cuda", host_chunks=chunks,
                     mxu_precision="bf16", repetitions=reps,
                     save_results=False, log_level=0)
    counts = _counts(pn, ov, gp, tl, st)
    n = counts.pop("stream:local_bf16", 0)
    label = f"outofcore[stream x{chunks} chunks]"
    if oc.backend != label or n != chunks * (reps + 1) or counts:
        raise RuntimeError(f"{p.name}: {oc.backend} launched K4's bf16 "
                           f"passes {n} times over {reps + 1} calls of "
                           f"{chunks} chunks (others {counts})")
    within = arrays_are_equal(f32_out, oc.outputs[o], BF16_VERIFY_RTOL)
    drift = _rel(oc.outputs[o], f32_out)
    print(f"outofcore: {p.name} --host-chunks {chunks} --mxu-precision "
          f"bf16: {oc.backend} {oc.wall_time_s * 1e3:.3f} ms per call (CUDA "
          f"events over {reps} calls, transfers included) | in-core f32 "
          f"route {route} {route_ms:.3f} ms | from it: max diff "
          f"{drift:.3g} of the largest output "
          f"({'within' if within else 'OUTSIDE'} BF16_VERIFY_RTOL) | K4 "
          f"bf16 launches {n} over "
          f"{reps + 1} calls | {smi}", flush=True)
    if not within:
        raise RuntimeError(f"{p.name}: the bf16 chunks are not within "
                           "BF16_VERIFY_RTOL of the f32 route")
    entry["launches"] = n
    del oc, f32_out
    torch.cuda.empty_cache()
    return entry


def _measurement(pn, smi):
    """Phase 6: the probes P4, P1 and P7 against their plain versions,
    then the measurement path with the counts reset (the probes' entry
    points, and one bench session whose fractions of every bound must be
    at most 1).  Returns the probes' entries of the kernels line."""
    import contextlib
    import io
    import torch
    from stencilflow_tpu_torch import bench
    from stencilflow_tpu_torch.probes import alu_ceiling as pa
    from stencilflow_tpu_torch.probes import copy_floor as pc
    from stencilflow_tpu_torch.probes import differenced_ms
    from stencilflow_tpu_torch.probes import loop_copy as pl
    from stencilflow_tpu_torch.report import HardwareModel
    hw = HardwareModel()
    entry = dict(route="cuda", launches=0, library_ms=None)

    # P4 at 512 x 512^2 (512 MiB each way), beside copy_
    x = torch.rand(pc.BIG, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    y = pc.copy(x, torch.full_like(x, float("nan")))
    torch.cuda.synchronize()
    if not torch.equal(x, y):
        raise RuntimeError("the copy kernel's output differs from its input")
    p4 = dict(entry, name="copy_floor",
              source="stencilflow_tpu_torch/csrc/probes/copy.cu",
              replaces="scripts/dma_matrix_probe.py:36",
              max_abs_err=float((y - x).abs().max()),
              ms=_time_ms(lambda: pc.copy(x, y), 10),
              plain_ms=_time_ms(lambda: pc.copy_plain(x), 3),
              library_ms=_time_ms(lambda: y.copy_(x), 10),
              bound_ms=8 * x.numel() / hw.hbm_bandwidth * 1e3,
              bound_by="bytes")
    print(f"kernel: copy_floor {tuple(x.shape)} {pc.DEFAULT}: "
          f"{p4['ms']:.4f} ms ({8 * x.numel() / p4['ms'] / 1e6:.1f} GB/s), "
          f"plain version {p4['plain_ms']:.4f} ms, copy_ "
          f"{p4['library_ms']:.4f} ms, bound {p4['bound_ms']:.4f} ms "
          f"(bytes), bit-equal OK | {smi}", flush=True)
    del x, y
    torch.cuda.empty_cache()

    # P1: every op at 8 steps against its plain version on the card (the
    # plain versions of the script's variant bodies timed)
    xa = pa.inputs(pa.elements(), "cuda")
    worst = 0.0
    variants = pa.OPS[pa.OPS.index("mul4"):]
    var_plain = {}
    for op, smem in [(op, False) for op in pa.OPS] + [("add", True)]:
        got = pa.alu(op, xa, 8, smem=smem)
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        want = pa.alu_plain(op, xa, 8)
        torch.cuda.synchronize()
        ok, err = pa.compare(op, got, want)
        if op in variants:
            var_plain[op] = (err, (time.perf_counter() - t_plain) * 1e3)
        if not ok:
            raise RuntimeError(f"alu kernel ({op}{', smem' if smem else ''})"
                               f" disagrees with its plain version: max "
                               f"abs diff {err:.3g}")
        worst = max(worst, err)
    steps = 64
    t_plain = time.perf_counter()
    pa.alu_plain("add", xa, steps)
    torch.cuda.synchronize()
    p1 = dict(entry, name="alu_ceiling",
              source="stencilflow_tpu_torch/csrc/probes/alu.cu",
              replaces="scripts/vpu_ceiling.py:240", max_abs_err=worst,
              ms=_time_ms(lambda: pa.alu("add", xa, steps), 10),
              plain_ms=(time.perf_counter() - t_plain) * 1e3,
              bound_ms=xa.numel() * pa.UNROLL * steps / hw.alu_ops * 1e3,
              bound_by="operations")
    print(f"compare: alu {len(pa.OPS)} ops and the shared-memory add at 8 "
          f"steps: max_abs_err {worst:.3g} OK | kernel: alu_ceiling add "
          f"{xa.numel()} x {pa.UNROLL} x {steps}: {p1['ms']:.4f} ms, plain "
          f"version {p1['plain_ms']:.1f} ms, bound {p1['bound_ms']:.4f} ms "
          f"(operations) | {smi}", flush=True)

    # the measurement path, each probe with its count reset just before it
    # and read just after; P7 launches P4's kernel, so its launches are
    # P4's count over P7's run.  Graph-timed probes count the warm-up and
    # each capture's recorded launches; the replays re-run those without
    # passing through a wrapper and are not counted.
    counted = "eager launches and graph captures; replays not counted"
    pc.launches = 0
    copy_rows = pc.measure([c for c in pc.CASES if c[1] == pc.BIG
                            and c[0] in ("flat f4 256t 8/SM",
                                         "tile f4 256t 4 rows")], trials=3)
    p4.update(launches=pc.launches, launches_counted=counted)
    pa.launches = 0
    alu_rows = pa.measure(("add", "fma", "fma_fused"), trials=3)
    p1["launches"] = pa.launches
    # the variant bodies, each measured with the count reset just before
    # and read just after, then timed at 8 steps beside its plain version
    var_entries = {}
    for op in variants:
        pa.launches = 0
        row = pa.measure((op,), trials=3, smem=False)[0]
        n = pa.launches
        ms = _time_ms(lambda op=op: pa.alu(op, xa, 8), 5)
        err, plain_ms = var_plain[op]
        apps = pa.APPLICATIONS.get(op, 1)
        bound_ms = xa.numel() * pa.UNROLL * 8 * apps / hw.alu_ops * 1e3
        var_entries["alu_ceiling_" + op] = dict(
            entry, name="alu_ceiling_" + op,
            source="stencilflow_tpu_torch/csrc/probes/alu.cu",
            replaces="scripts/vpu_ceiling.py:240", launches=n,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="operations")
        print(f"kernel: alu_ceiling {op} {xa.numel()} x {pa.UNROLL} x 8 "
              f"({apps} counted ops an application): {ms:.4f} ms, plain "
              f"version {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
              f"(operations), max_abs_err {err:.3g} | measured "
              f"{row['ops_per_s'] / 1e12:.3f} Top/s ({row['ms_per_step']:.4f}"
              f" ms a step), launches {n} | {smi}", flush=True)
        if n < 1:
            raise RuntimeError(f"the measurement path skipped alu {op}")
    pc.launches = 0
    loops = pl.measure(unrolls=(1, 2), trials=3)
    p7_launches = pc.launches
    pn.launches_by["exact"] = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(["--workload", "jacobi", "--sessions", "1"])
    bench_launches = pn.launches_by["exact"]
    line = out.getvalue().strip().splitlines()[-1]
    print(f"bench: {line}", flush=True)
    rec = json.loads(line)
    fractions = dict(rec["bounds"], vs_baseline=rec["vs_baseline"])
    if not all(0 < v <= 1.0 for v in fractions.values()):
        raise RuntimeError(f"a bound fraction outside (0, 1]: {fractions}")
    counts = {"copy_floor": p4["launches"], "alu_ceiling": p1["launches"],
              "loop_copy": p7_launches, "panel (bench)": bench_launches}
    if min(counts.values()) < 1:
        raise RuntimeError(f"the measurement path skipped a kernel: "
                           f"{counts}")
    for r in copy_rows:
        print(f"probe: P4 {r['case']} {r['ms']:.4f} ms {r['gb_s']:.1f} GB/s "
              f"| {smi}", flush=True)
    for r in alu_rows:
        print(f"probe: P1 {r['op']} {r['ops_per_s'] / 1e12:.3f} Top/s "
              f"({r['vs_add']:.2f} x add) | {smi}", flush=True)
    for r in loops["cases"]:
        print(f"probe: P7 planes {r['planes']} U={r['unroll']} {r['mode']} "
              f"{r['ms'] * 1e3:.3f} us per application, max_abs_err "
              f"{r['max_abs_err']:.3g} | {smi}", flush=True)
    print(f"probe: P7 host cost of one eager launch "
          f"{loops['host_us_per_launch']:.2f} us | launches {counts} "
          f"({counted})", flush=True)

    # P7 at its main shape: 512 planes, two applications per iteration,
    # eager; its plain version (a new tensor per application) and copy_
    # between the same ping-pong buffers, timed the same way
    eager = next(r for r in loops["cases"] if r["planes"] == 512
                 and r["unroll"] == 2 and r["mode"] == "eager")
    a = torch.rand(pc.BIG, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    b = torch.empty_like(a)
    plain_ms = differenced_ms(lambda n: pl.loop_plain(a, n, 2), 2, 10,
                              3) / 2
    library_ms = differenced_ms(
        lambda n: pl.loop(a, b, n, 2, body=lambda s, d: d.copy_(s)), 2, 10,
        3) / 2
    p7 = dict(entry, name="loop_copy",
              source="stencilflow_tpu_torch/probes/loop_copy.py",
              replaces="scripts/loop_copy_probe.py:37",
              launches=p7_launches, launches_counted=counted,
              max_abs_err=max(r["max_abs_err"] for r in loops["cases"]),
              ms=eager["ms"], plain_ms=plain_ms, library_ms=library_ms,
              bound_ms=8 * a.numel() / hw.hbm_bandwidth * 1e3,
              bound_by="bytes")
    print(f"kernel: loop_copy {tuple(a.shape)} U=2 eager: {p7['ms']:.4f} "
          f"ms per application, plain version {plain_ms:.4f} ms, copy_ "
          f"{library_ms:.4f} ms, bound {p7['bound_ms']:.4f} ms (bytes), "
          f"max_abs_err {p7['max_abs_err']:.3g} | {smi}", flush=True)
    del a, b
    torch.cuda.empty_cache()
    return {"copy_floor": p4, "alu_ceiling": p1, "loop_copy": p7,
            **var_entries}


def _autotune_thunks(program, build_s):
    """One thunk per default autotune label of ``program``: phase 2 runs
    them beside its other builds (a planner's refusal or a label that
    does not apply builds nothing), each thunk's seconds into
    ``build_s``."""
    from stencilflow_tpu_torch import autotune as at

    def build(label):
        t0 = time.perf_counter()
        try:
            at.build_from_label(program, label, device="cuda")
        except (KeyError, ValueError, NotImplementedError):
            return
        build_s[label] = time.perf_counter() - t0
    return [lambda label=label: build(label) for label in at.DEFAULT_LABELS]


def _autotune_leg(sft, st, pn, ov, gp, tl, program, build_s, smi,
                  run_program):
    """Phase 4, continued: ``compile_chain_autotuned`` on ``program`` with
    the default labels, one trial, a temporary cache; each measured
    candidate against ``dense``; a second call from the cache; ``run
    --backend autotuned``.  Counts are reset just before each drive and
    read just after: every timed candidate's kernel must launch, and the
    winner's again through ``run_program``."""
    import tempfile

    import torch
    from stencilflow_tpu_torch import autotune as at
    from stencilflow_tpu_torch.backend import compile_chain
    from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL
    counters = {"stream": lambda: (st.launches_by["exact"]
                                   + st.launches_by["spill"]),
                "panel": lambda: pn.launches_by["exact"],
                "overlap": lambda: ov.launches_by["exact"],
                "group": lambda: gp.launches_by["exact"],
                "pallas": lambda: tl.launches_by["exact"]}

    def reset():
        for m in (pn, ov, gp, tl):
            m.launches_by["exact"] = 0
        for k in ("exact", "spill", "local"):
            st.launches_by[k] = 0

    def launched(label):
        kind = label.split(":")[0]
        return counters[kind]() if kind in counters else None

    t_leg = time.perf_counter()
    tuned = {}
    tune = at.autotune

    def keep(*a, **k):   # the result's timings, skips and build seconds
        tuned["res"] = tune(*a, **k)
        return tuned["res"]

    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "autotune.json")
        at.autotune = keep
        try:
            reset()
            fn, label = at.compile_chain_autotuned(program, cache_path=cache,
                                                   device="cuda", trials=1)
            torch.cuda.synchronize()
            counts = {l: launched(l) for l in tuned["res"].timings}
        finally:
            at.autotune = tune
        res = tuned["res"]
        idle = [l for l, n in counts.items() if n == 0]
        if idle:
            raise RuntimeError(f"autotune: {idle} timed without a launch")
        print(f"autotune: {program.name} winner {label} "
              f"{res.seconds * 1e3:.3f} ms | " + ", ".join(
                  f"{l} {t * 1e3:.3f} ms" for l, t in res.timings.items())
              + " | skipped: " + (", ".join(
                  f"{l} ({why.splitlines()[0][:50]})"
                  for l, why in res.skipped.items()) or "none")
              + " | build s (phase 2): " + ", ".join(
                  f"{l} {build_s.get(l, 0.0):.1f}" for l in res.timings)
              + f" | launches {counts} | {smi}", flush=True)
        # each measured candidate against dense on the same inputs
        inputs = {k: v if program.inputs[k].is_scalar else
                  torch.as_tensor(np.asarray(v)).cuda()
                  for k, v in sft.load_input_arrays(program,
                                                    seed=0).items()}
        want = {o: v.cpu().numpy()
                for o, v in compile_chain(program)(inputs).items()}
        errs = {}
        for l in res.timings:
            cand = at.build_from_label(program, l, device="cuda")
            banded = bool(getattr(cand, "last_config", {}).get(
                "mxu_stages"))
            got = cand(inputs)
            for o in program.outputs:
                ok, err = _compare(got[o].cpu().numpy(), want[o],
                                   MXU_VERIFY_RTOL if banded else 0.0)
                if not ok:
                    raise RuntimeError(f"autotune: {l} disagrees with dense "
                                       f"on {program.name} ({err:.3g})")
                errs[l] = max(errs.get(l, 0.0), err)
            del got
        del inputs
        torch.cuda.empty_cache()

        def boom(*a, **k):
            raise RuntimeError("autotune: the second call tuned again")
        at.autotune = boom
        try:
            _fn, again = at.compile_chain_autotuned(program, cache_path=cache,
                                                    device="cuda")
        finally:
            at.autotune = tune
        if again != label:
            raise RuntimeError(f"autotune: the cache gave {again}, the "
                               f"tuning {label}")
        before = os.environ.get("SFT_AUTOTUNE_CACHE")
        os.environ["SFT_AUTOTUNE_CACHE"] = cache
        try:
            reset()
            run = run_program(program, device="cuda", backend="autotuned",
                              compare_to_reference=True, repetitions=20,
                              save_results=False, log_level=0)
            torch.cuda.synchronize()
            winner_launches = launched(label)
        finally:
            if before is None:
                del os.environ["SFT_AUTOTUNE_CACHE"]
            else:
                os.environ["SFT_AUTOTUNE_CACHE"] = before
    if run.backend != f"autotuned:{label}" or \
            not run.verified_against_reference or winner_launches == 0:
        raise RuntimeError(f"autotune: run_program took {run.backend}, "
                           f"verified {run.verified_against_reference}, "
                           f"winner launches {winner_launches}")
    print(f"autotune: every measured candidate equal to dense (banded "
          f"within MXU_VERIFY_RTOL; max abs err {errs}) | second call from "
          f"the cache: {again} | run --backend autotuned: {run.backend} "
          f"{run.wall_time_s * 1e3:.3f} ms, verified against reference OK, "
          f"winner launches {winner_launches} | leg took "
          f"{time.perf_counter() - t_leg:.1f} s | {smi}", flush=True)


def _solver_setup(sft, jacobi8):
    """The solvers phase's programs (phase 7), and one thunk per lowering
    it compiles: phase 2 runs them beside its other builds, so that every
    composed and adjoint program's kernel is built in parallel."""
    from stencilflow_tpu_torch import solver_cells as sc
    from stencilflow_tpu_torch.backend import compile_chain_best
    from stencilflow_tpu_torch.grad import adjoint_program
    from stencilflow_tpu_torch.iterate import compose_iterations
    from stencilflow_tpu_torch.outofcore import compile_chunked_chain
    from stencilflow_tpu_torch.synthesize import jacobi, synthesize_stencil
    progs = {
        "jacobi512": sft.parse_program(jacobi(3, 512, 1),
                                       name="jacobi3d_512"),
        "jacobi1024": sft.parse_program(jacobi(3, 1024, 1),
                                        name="jacobi3d_1024"),
        "gray_scott": sc.gray_scott(8192),
        "grad": jacobi8,
        "grad_copy": sft.parse_program(synthesize_stencil(
            num_stages=8, dimensions=(256,) * 3, shape="diffusion",
            boundary="copy", seed_data="random:0.0,1.0"),
            name="jacobi3d_256_8itr_copy"),
        "diffusion": sc.implicit_diffusion(512),
        "upwind": sc.upwind(512),
    }
    fused1024 = compose_iterations(progs["jacobi1024"], 8)
    in_core = [compose_iterations(progs["jacobi512"], 8),
               progs["jacobi512"], fused1024,
               compose_iterations(progs["gray_scott"], 4,
                                  sc.GRAY_SCOTT_FEED),
               progs["gray_scott"], adjoint_program(jacobi8)[0],
               progs["grad_copy"], adjoint_program(progs["grad_copy"])[0],
               progs["diffusion"], progs["upwind"],
               adjoint_program(progs["upwind"], wrt=["x"])[0]]
    thunks = [lambda p=p: compile_chain_best(p, device="cuda")
              for p in in_core]
    thunks += [lambda: compile_chunked_chain(fused1024, 8, device="cuda"),
               lambda: compile_chunked_chain(progs["diffusion"], 4,
                                             device="cuda")]
    return progs, thunks


def _device_random(shape, seed: int) -> np.ndarray:
    """Uniform [0, 1) float32 host data drawn on the card (fast at 1024^3)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(shape, generator=gen, device="cuda").cpu().numpy()


def _eager(step, inputs, n: int):
    """``n`` eager steps of ``step`` from host ``inputs``; host arrays."""
    import torch
    state = {k: (torch.as_tensor(v).cuda() if np.ndim(v) else v)
             for k, v in inputs.items()}
    for _ in range(n):
        state = step(state)
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in state.items()}


def _replay_ms(program, inputs, fuse: int, n: int, feed=None) -> float:
    """ms per original step of one replay of the graph of ``n`` fused
    steps, as ``iterate`` captures it (CUDA events, after the capturing
    replay)."""
    import torch
    from stencilflow_tpu_torch.iterate import (GraphLoop, compose_iterations,
                                               make_step)
    if fuse > 1:
        program = compose_iterations(program, fuse, feed)
    step, feed = make_step(program, feed, device="cuda")
    state = {k: (torch.as_tensor(v).cuda() if np.ndim(v) else v)
             for k, v in inputs.items()}
    loop = GraphLoop(step, state, feed, torch.device("cuda"))
    ms = _time_ms(lambda: loop.run(n), 1)
    del loop, state
    torch.cuda.empty_cache()
    return ms / (n * fuse)


def _solvers(sft, progs, smi, k1_ms: float):
    """Phase 7: the solver entry points at full width, each against its
    reference (module docstring), with the kernels' counts reset just
    before and read just after.  Returns the counts."""
    import torch
    from stencilflow_tpu_torch import solver_cells as sc
    from stencilflow_tpu_torch.backend import group as gp
    from stencilflow_tpu_torch.backend import overlap as ov
    from stencilflow_tpu_torch.backend import panel as pn
    from stencilflow_tpu_torch.backend import stream as st
    from stencilflow_tpu_torch.backend.dense import compile_chain
    from stencilflow_tpu_torch.config import VERIFY_RTOL
    from stencilflow_tpu_torch.iterate import make_step
    for m in (pn, ov, gp):
        m.launches_by["exact"] = 0
    for k in ("exact", "local", "spill"):
        st.launches_by[k] = 0

    def check(ok, what):
        if not ok:
            raise RuntimeError(f"solvers: {what}")

    # iterate on jacobi3d 512^3, 64 steps: fused by 8 (K1) and one step a
    # stage (K2), bit for bit with each other and with dense stepping
    j = progs["jacobi512"]
    inputs = {"a": _device_random((512,) * 3, 0)}
    got, ms, route = {}, {}, {}
    for fuse in (8, 1):
        stats = {}
        got[fuse] = sft.iterate(j, inputs, 64, fuse=fuse, stats=stats)["a"]
        route[fuse] = stats["backend"]
        ms[fuse] = _replay_ms(j, inputs, fuse, 64 // fuse)
    dense = _eager(make_step(j, backend="dense")[0], inputs, 64)["a"]
    equal = (np.array_equal(got[8], got[1]),
             np.array_equal(got[1], dense))
    print(f"solvers: iterate {j.name} x 64 steps: fuse 8 {route[8]} "
          f"{ms[8]:.4f} ms a step, fuse 1 {route[1]} {ms[1]:.4f} ms a step "
          f"(graph replays; K1's one-shot 8 stages {k1_ms / 8:.4f} ms a "
          f"stage); fuse 8 == fuse 1: {equal[0]}, == dense x 64: "
          f"{equal[1]} | {smi}", flush=True)
    check(all(equal), "iterate fuse 8 / fuse 1 / dense differ")
    del got, dense, inputs
    torch.cuda.empty_cache()

    # Gray-Scott 8192^2, two fields fed, copy BCs: fused by 4 against one
    # step a chain and dense stepping, 16 steps
    gs, feed = progs["gray_scott"], sc.GRAY_SCOTT_FEED
    inputs = sft.load_input_arrays(gs)
    stats = {}
    fused = sft.iterate(gs, inputs, 16, feed=feed, fuse=4, stats=stats)
    one_stats = {}
    one = sft.iterate(gs, inputs, 16, feed=feed, fuse=1, stats=one_stats)
    dense = _eager(make_step(gs, feed, backend="dense")[0], inputs, 16)
    equal = all(np.array_equal(fused[k], one[k]) and
                np.array_equal(one[k], dense[k]) for k in feed)
    finite = all(np.isfinite(fused[k]).all() for k in feed)
    ms4 = _replay_ms(gs, inputs, 4, 4, feed)
    ms1 = _replay_ms(gs, inputs, 1, 16, feed)
    print(f"solvers: iterate gray_scott 8192^2 x 16 steps: fuse 4 "
          f"{stats['backend']} {ms4:.4f} ms a step, fuse 1 "
          f"{one_stats['backend']} {ms1:.4f} ms a step; bit-equal across "
          f"fuse and to dense: {equal}, finite: {finite} | {smi}",
          flush=True)
    check(equal and finite, "gray-scott fuse 4 / fuse 1 / dense differ")
    gs_route = stats["backend"]
    del fused, one, dense, inputs
    torch.cuda.empty_cache()

    # out of core: jacobi3d 1024^3 fused by 8, 16 steps at 8 chunks (K4)
    # against in-core iterate (K1)
    j = progs["jacobi1024"]
    inputs = {"a": _device_random((1024,) * 3, 1)}
    oc_stats, ic_stats = {}, {}
    t0 = time.perf_counter()
    oc = sft.iterate(j, inputs, 16, fuse=8, host_chunks=8,
                     stats=oc_stats)["a"]
    oc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ic = sft.iterate(j, inputs, 16, fuse=8, stats=ic_stats)["a"]
    ic_s = time.perf_counter() - t0
    equal = np.array_equal(oc, ic)
    print(f"solvers: iterate {j.name} x 16 steps, fuse 8: "
          f"{oc_stats['backend']} {oc_s:.2f} s against in-core "
          f"{ic_stats['backend']} {ic_s:.2f} s (host clock, transfers and "
          f"set-up included); bit-equal: {equal} | {smi}", flush=True)
    check(equal, "out-of-core iterate differs from in-core")
    del oc, ic, inputs
    torch.cuda.empty_cache()

    # gradients: the bench's chain (512^3 x 8) through the kernels, the
    # gradient against dense of the adjoint program on the same cotangent
    for key in ("grad", "grad_copy"):
        p = progs[key]
        inputs = {n: torch.as_tensor(v).cuda() for n, v in
                  sft.load_input_arrays(p, seed=0).items()}
        torch.cuda.reset_peak_memory_stats()
        f = sft.fast_value_and_grad(p)
        val, grads = f(inputs)
        fast_ms = _time_ms(lambda: f(inputs), 3)
        fast_peak = torch.cuda.max_memory_allocated()
        adj, cot = sft.adjoint_program(p)
        adj_in = {n: torch.as_tensor(np.asarray(v)).cuda()
                  for n, v in sft.load_input_arrays(adj).items()}
        want = compile_chain(adj)(adj_in)["adj_a"].reshape(grads["a"].shape)
        equal = torch.equal(grads["a"], want)
        del adj_in, want
        line = (f"solvers: fast_value_and_grad {p.name}: forward "
                f"{f.lowering['forward']}, adjoint {f.lowering['adjoint']} "
                f"({len(adj.inputs) - 1} 1-D indicator inputs), "
                f"{fast_ms:.3f} ms a call, peak {fast_peak / 2 ** 30:.2f} "
                f"GiB; gradient == dense of the adjoint: {equal}")
        check(equal, f"{p.name}: fast gradient differs from dense of the "
                     "adjoint")
        # dense autodiff (value_and_grad) beside, with its peak memory
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        g = sft.value_and_grad(p)
        dval, dgrads = g(inputs)
        dense_ms = _time_ms(lambda: g(inputs), 1)
        dense_peak = torch.cuda.max_memory_allocated()
        close = sft.arrays_are_equal(dgrads["a"].cpu().numpy(),
                                     grads["a"].cpu().numpy(),
                                     VERIFY_RTOL) and \
            abs(float(dval) - float(val)) <= \
            VERIFY_RTOL * abs(float(dval))
        line += (f" | value_and_grad (dense autodiff) {dense_ms:.3f} ms "
                 f"a call ({dense_ms / fast_ms:.1f}x), peak "
                 f"{dense_peak / 2 ** 30:.2f} GiB; within VERIFY_RTOL: "
                 f"{close}")
        check(close, f"{p.name}: value_and_grad differs from the fast "
                     "gradient")
        del dgrads, g
        print(line + f" | {smi}", flush=True)
        del f, grads, inputs
        torch.cuda.empty_cache()

    # CG and CGNR at 512^3: iterations, true residual, ms an iteration
    # split into the operator and the vector passes; then CG out of core
    rhs = _device_random((512,) * 3, 2)
    rhs_dev = torch.as_tensor(rhs).cuda()
    tol = 1e-6
    for key, method in (("diffusion", "cg"), ("upwind", "cgnr")):
        solver = sft.make_solver(progs[key], method=method, tol=tol,
                                 maxiter=3000)
        solver(rhs_dev)   # first use (cuBLAS, the caching allocator)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        x, info = solver(rhs_dev)
        stop.record()
        torch.cuda.synchronize()
        total = start.elapsed_time(stop)
        op_ms = _time_ms(lambda: solver.operator(x), 5)
        per = total / max(info["iterations"], 1)
        print(f"solvers: {method} {progs[key].name}: "
              f"{solver.lowering}, {info['iterations']} iterations, true "
              f"relative residual {info['residual']:.3e} (tol {tol}), "
              f"{per:.3f} ms an iteration: operator {op_ms:.3f}, vector "
              f"passes {per - op_ms:.3f} | {smi}", flush=True)
        check(info["residual"] <= tol * 100,
              f"{method} residual {info['residual']} above tol * 100")
        del solver, x
        torch.cuda.empty_cache()
    # out of core, cut to its first 4 iterations: against the in-core
    # solver stopped at the same iteration
    x_in = sft.make_solver(progs["diffusion"], tol=tol, maxiter=4)(
        rhs_dev)[0].cpu().numpy()
    t0 = time.perf_counter()
    x_oc, info = sft.make_solver(progs["diffusion"], tol=tol, maxiter=4,
                                 host_chunks=4)(rhs)
    oc_s = time.perf_counter() - t0
    rel = float(np.linalg.norm(x_oc - x_in) / np.linalg.norm(x_in))
    print(f"solvers: cg {progs['diffusion'].name} at 4 host chunks: "
          f"{info['iterations']} iterations, residual "
          f"{info['residual']:.3e}, {oc_s:.2f} s (host clock); relative "
          f"distance to the in-core x {rel:.3e} (limit {10 * tol}) | {smi}",
          flush=True)
    check(rel <= 10 * tol, "out-of-core CG differs from in-core")

    counts = {"panel": pn.launches_by["exact"],
              "overlap": ov.launches_by["exact"],
              "group": gp.launches_by["exact"],
              "local_stream": st.launches_by["local"],
              "stream": st.launches_by["exact"],
              "stream_spill": st.launches_by["spill"]}
    print(f"solvers: launches {counts} (warm-up and capture launches; a "
          f"graph replay re-runs its captured launches without the "
          f"wrappers) | {smi}", flush=True)
    need = ["panel", "overlap", "local_stream"]
    if gs_route == "rows+group_g8":
        need.append("group")
    for name in need:
        check(counts[name] > 0, f"the solver paths never launched {name}")
    return counts


def _simulator(sft, run_program, smi):
    """Phase 8: ``run --run-simulation`` through the main-path kernels.
    ``cli simulate --trace-chrome`` on a 16^3 program starts first, in a
    subprocess; each leg's native simulator core and kernel are built
    (g++ and nvcc, all at once, on threads); then each leg runs
    ``run_program(..., run_simulation=True, compare_to_reference=True)``:
    the jacobi3d 256^3 x 8 leg on one thread, the others in turn on another
    (the simulator and the oracle run on the host and release the GIL),
    with the kernels' counts reset just before the legs and read just
    after."""
    import tempfile

    from stencilflow_tpu_torch.synthesize import synthesize_stencil
    t_phase = time.perf_counter()

    # cli simulate --trace-chrome on 16^3 (the host), and cli import-sdfg
    # then cli compile of hdiff 256^3, beside the legs
    with tempfile.TemporaryDirectory() as tmp:
        prog = os.path.join(tmp, "prog.json")
        trace = os.path.join(tmp, "trace.json")
        with open(prog, "w") as f:
            json.dump(synthesize_stencil(
                num_stages=2, dimensions=(16,) * 3, shape="diffusion",
                seed_data="random:0.0,1.0"), f)
        cli = subprocess.Popen(
            [sys.executable, "-m", "stencilflow_tpu_torch.cli", "simulate",
             prog, "--trace-chrome", trace], cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        with ThreadPoolExecutor(max_workers=1) as ex:
            imported = ex.submit(_import_and_compile, tmp)
            try:
                _simulator_legs(sft, run_program, smi, t_phase)
                out, err = cli.communicate(timeout=300)
            finally:
                if cli.poll() is None:
                    cli.kill()
                    cli.communicate()
            if cli.returncode != 0 or not os.path.isfile(trace) \
                    or os.path.getsize(trace) == 0:
                raise RuntimeError(f"simulator: cli simulate exited "
                                   f"{cli.returncode}: {err[-2000:]}")
            _imported_hdiff(sft, run_program, imported.result(), smi)
        events = json.load(open(trace))["traceEvents"]
    if not any(e["ph"] == "X" for e in events):
        raise RuntimeError("simulator: the chrome trace has no spans")
    cycles = next(ln for ln in out.splitlines() if ln.startswith("cycles: "))
    print(f"simulate: cli simulate 16^3 --trace-chrome: {cycles}, "
          f"{len(events)} events (a subprocess beside the legs)",
          flush=True)
    print(f"simulate: phase 8 took {time.perf_counter() - t_phase:.1f} s "
          f"| {smi}", flush=True)


HDIFF_SDFG = os.path.join(HERE, "tests", "fixtures", "hdiff.sdfg")


def _import_and_compile(tmp):
    """Phase 8's CLI legs, in subprocesses one after the other: ``cli
    import-sdfg`` of the hdiff fixture at 256^3 and ``cli compile`` of
    the program it wrote.  Returns (program JSON path, .cu path, the two
    stdouts, the compile's seconds)."""
    cmd = [sys.executable, "-m", "stencilflow_tpu_torch.cli"]
    spec, cu = os.path.join(tmp, "hdiff256.json"), os.path.join(
        tmp, "hdiff256.cu")
    outs = []
    for argv in (["import-sdfg", HDIFF_SDFG, "--dimensions", "256,256,256",
                  "--input-data", "random:0,1", "-o", spec],
                 ["compile", spec, "-o", cu]):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + argv, cwd=HERE, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"simulator: cli {argv[0]} exited "
                               f"{proc.returncode}: {proc.stderr[-2000:]}")
        outs.append(proc.stdout.strip())
    return spec, cu, outs, time.perf_counter() - t0


def _imported_hdiff(sft, run_program, imported, smi):
    """The hdiff fixture as ``cli import-sdfg`` wrote it at 256^3, held to
    ``sdfg_to_program``, compiled by ``cli compile`` into the route's
    source and a library, and run on K1 (counted) against the oracle bit
    for bit."""
    import stencilflow_tpu_torch.driver as drv
    from stencilflow_tpu_torch.backend import panel as pn
    from stencilflow_tpu_torch.backend import route_source
    from stencilflow_tpu_torch.frontend.sdfg_import import sdfg_to_program
    spec, cu, (imp_out, comp_out), compile_s = imported
    t0 = time.perf_counter()
    want = sft.program_to_json(sdfg_to_program(
        HDIFF_SDFG, dimensions=(256, 256, 256), input_data="random:0,1"))
    if json.load(open(spec)) != json.loads(json.dumps(want)):
        raise RuntimeError("simulator: cli import-sdfg wrote another "
                           "program than sdfg_to_program")
    program = sft.parse_program(spec)
    backend, source, _lib = route_source(program)
    built = comp_out.splitlines()[-1]
    lib = built.split()[1] if built.startswith("built ") else ""
    if (backend != "panel" or open(cu).read() != source
            or not os.path.isfile(lib) or os.path.getsize(lib) == 0):
        raise RuntimeError(f"simulator: cli compile of the imported hdiff "
                           f"did not write and build K1: {comp_out!r}")

    real, oracle = drv.run_interpreter, {}

    def kept(p, inputs):
        oracle.update(real(p, inputs))
        return oracle
    drv.run_interpreter = kept
    pn.launches_by["exact"] = 0
    try:
        res = run_program(program, device="cuda", repetitions=5,
                          compare_to_reference=True, save_results=False,
                          log_level=0)
    finally:
        drv.run_interpreter = real
    launched = pn.launches_by["exact"]
    if res.backend != "panel" or launched < 1:
        raise RuntimeError(f"simulator: the imported hdiff took "
                           f"{res.backend}, K1 launched {launched} times")
    for o in program.outputs:
        if not np.array_equal(res.outputs[o], np.asarray(oracle[o])):
            raise RuntimeError(f"simulator: the imported hdiff's {o} is not "
                               "the oracle's bit for bit")
    bound, by = _bound(program)
    print(f"simulate: {imp_out} | the imported hdiff 256^3 "
          f"({len(program.kernels)} kernels) route {res.backend}: K1 "
          f"launches {launched}, {res.wall_time_s * 1e3:.3f} ms a call "
          f"(CUDA events, 5 calls), bound {bound:.4f} ms ({by}), equal to "
          f"the oracle bit for bit | cli compile: {comp_out.splitlines()[0]}"
          f"; {built} (the subprocess {compile_s:.1f} s) | leg "
          f"{time.perf_counter() - t0:.1f} s | {smi}", flush=True)


def _simulator_legs(sft, run_program, smi, t_phase):
    """Phase 8's legs (``_simulator``)."""
    from concurrent.futures import ThreadPoolExecutor

    import stencilflow_tpu_torch.sim as simmod
    from stencilflow_tpu_torch.backend import compile_chain_best
    from stencilflow_tpu_torch.backend import group as gp
    from stencilflow_tpu_torch.backend import overlap as ov
    from stencilflow_tpu_torch.backend import panel as pn
    from stencilflow_tpu_torch.backend import stream as st
    from stencilflow_tpu_torch.backend import tile as tl
    from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL
    from stencilflow_tpu_torch.sim.native import NativeSimulator
    from stencilflow_tpu_torch.synthesize import (mixed_dtype_spec,
                                                  synthesize_stencil)

    def synth(shape, dims, stages, extent=1):
        return sft.parse_program(synthesize_stencil(
            num_stages=stages, dimensions=dims, shape=shape, extent=extent,
            seed_data="random:0.0,1.0"),
            name=f"{shape}{len(dims)}d_{dims[0]}_{stages}itr")
    # (program, the route it must take; None: any, printed)
    legs = [(synth("diffusion", (256,) * 3, 8), "panel"),
            (synth("diffusion", (256,) * 3, 2), "overlap"),
            (synth("hotspot", (4096, 4096), 4), "rows+group_g8"),
            (synth("box", (128,) * 3, 4, extent=2), "stream"),
            (sft.parse_program(*mixed_dtype_spec((48, 48, 48))), None)]

    def build_core(p):
        t0 = time.perf_counter()
        NativeSimulator(p)   # a NativeBuildError fails the phase
        return time.perf_counter() - t0
    with ThreadPoolExecutor(max_workers=2 * len(legs)) as ex:
        cores = [ex.submit(build_core, p) for p, _ in legs]
        kernels = [ex.submit(compile_chain_best, p, device="cuda")
                   for p, _ in legs]
        gxx_s = {p.name: f.result() for (p, _), f in zip(legs, cores)}
        for f in kernels:
            f.result()
    print(f"simulate: {len(legs)} native cores (g++) and kernels (nvcc) "
          f"built at once in {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # time each simulation inside run_program and keep its result
    real, seen = simmod.simulate, {}

    def timed(program, inputs, **kw):
        t0 = time.perf_counter()
        res = real(program, inputs, **kw)
        seen[program.name] = (time.perf_counter() - t0, res)
        return res

    def leg(p, want):
        t0 = time.perf_counter()
        res = run_program(p, device="cuda", run_simulation=True,
                          compare_to_reference=True, save_results=False,
                          log_level=0)
        leg_s = time.perf_counter() - t0
        if want is not None and res.backend != want:
            raise RuntimeError(f"simulator: {p.name} took {res.backend}, "
                               f"expected {want}")
        if not (res.verified_against_simulation is True
                and res.verified_against_reference is True):
            raise RuntimeError(f"simulator: {p.name} not verified")
        sim_s, sim = seen.pop(p.name)
        banded = res.backend == "stream" and bool(st.plan_stream(p).tkeys)
        for o in p.outputs:
            if banded:
                ok = sft.arrays_are_equal(sim.outputs[o], res.outputs[o],
                                          MXU_VERIFY_RTOL)
            else:   # per-cell kernels and the mixed chain: bit-equal
                ok = np.array_equal(res.outputs[o], sim.outputs[o])
            if not ok or res.outputs[o].shape != tuple(p.raw_dimensions):
                raise RuntimeError(f"simulator: {p.name} {o} disagrees with "
                                   "the simulator")
        print(f"simulate: {p.name} route {res.backend} cycles "
              f"{res.simulation_cycles} elements {p.total_elements} | "
              f"simulator {sim_s:.2f} s on the host "
              f"({res.simulation_cycles / sim_s / 1e6:.2f} Mcycles/s), "
              f"g++ {gxx_s[p.name]:.2f} s (in parallel) | kernel "
              f"{res.wall_time_s * 1e3:.3f} ms | "
              f"{'within MXU_VERIFY_RTOL of' if banded else 'equal to'} "
              f"the simulator, oracle OK | leg {leg_s:.1f} s | {smi}",
              flush=True)
        return res.backend

    simmod.simulate = timed
    for m in (pn, ov, gp, tl):
        m.launches_by["exact"] = 0
    for k in ("exact", "local", "spill"):
        st.launches_by[k] = 0
    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            big = ex.submit(leg, *legs[0])
            rest = ex.submit(lambda: [leg(*lg) for lg in legs[1:]])
            routes = [big.result()] + rest.result()
    finally:
        simmod.simulate = real
    counts = {"panel": pn.launches_by["exact"],
              "overlap": ov.launches_by["exact"],
              "stream": st.launches_by["exact"],
              "rows+group_g8": gp.launches_by["exact"],
              "tile": tl.launches_by["exact"]}
    print(f"simulate: launches {counts} over the legs", flush=True)
    for route in routes:
        if counts.get(route, 0) < 1:
            raise RuntimeError(f"simulator: the legs never launched the "
                               f"{route} kernel ({counts})")


def _sharded_setup(sft, jacobi8, box256):
    """Phase 9's programs: (cells, K4-vs-plain cases, solver programs) and
    one thunk per lowering they compile (the sharded engines' K4 shard
    plans and the single-device routes beside them): phase 2 runs the
    thunks beside its other builds.  Meshes repeat the one card (virtual
    shards)."""
    import torch
    from stencilflow_tpu_torch.backend import compile_chain_best
    from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL
    from stencilflow_tpu_torch.grad import adjoint_program
    from stencilflow_tpu_torch.iterate import compose_iterations
    from stencilflow_tpu_torch.parallel import (compile_pipeline_split,
                                                compile_sharded_chain)
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    from stencilflow_tpu_torch.synthesize import synthesize_stencil

    def synth(shape, n, iters, **kw):
        return sft.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=(n,) * 3, shape=shape,
            seed_data="random:0.0,1.0", **kw),
            name=f"{shape}3d_{n}_{iters}itr"
                 f"{'_' + kw['boundary'] if 'boundary' in kw else ''}")
    cuda = torch.device("cuda", 0)
    jk = ((2, 2), ("x", "y"), (None, "x", "y"))
    i4 = ((4,), ("x",), ("x", None, None))
    ijk = ((2, 2, 2), ("x", "y", "z"), ("x", "y", "z"))
    # (label, program, mesh, tolerance against the single-device route)
    cells = [("jacobi3d 512^3 x 8, 2 x 2 (None, x, y)", jacobi8, jk, 0.0),
             ("jacobi3d 512^3 x 8, 4 shards of i", jacobi8, i4, 0.0),
             ("hdiff3d 256^3 x 8 copy BCs, 2 x 2", synth(
                 "hdiff", 256, 8, boundary="copy"), jk, 0.0),
             ("box3d 256^3 x 8 extent 2, 2 x 2", box256, jk,
              MXU_VERIFY_RTOL)]
    kcases = [(f"jacobi3d 64^3 x 3 {bc}, 2 x 2 x 2",
               synth("diffusion", 64, 3, boundary=bc), ijk, 0.0)
              for bc in ("constant", "copy", "shrink")]
    kcases.append(("box 64^3 x 2 extent 1 BC 0.7, 2 x 2", synth(
        "box", 64, 2, extent=1, boundary_value=0.7), jk, MXU_VERIFY_RTOL))
    step = synth("diffusion", 256, 1)
    grad = synth("diffusion", 128, 8)
    solvers = {"iterate": step, "grad": grad, "mesh": jk}
    thunks = []
    for _label, p, (shape, names, axes), _tol in cells + kcases + [
            ("", compose_iterations(step, 8), jk, 0),
            ("", grad, jk, 0), ("", adjoint_program(grad)[0], jk, 0)]:
        mesh = make_mesh([cuda], shape, names)
        thunks.append(lambda p=p, m=mesh, a=axes: compile_sharded_chain(
            p, m, a))
    for p in [c[1] for c in cells] + [compose_iterations(step, 8), grad,
                                      adjoint_program(grad)[0]]:
        thunks.append(lambda p=p: compile_chain_best(p, device="cuda"))
    # the pipeline split: (label, program, mesh, compile options,
    # tolerance against the single-device route); every segment's K4
    # builds in its own nvcc, started with the other builds
    pipes = [("jacobi3d 512^3 x 8 over 4, sharded io", jacobi8,
              ((4,), ("p",)), {"io": "sharded"}, 0.0),
             ("jacobi3d 512^3 x 8 over 4, replicated io", jacobi8,
              ((4,), ("p",)), {"io": "replicated"}, 0.0),
             ("box3d 256^3 x 8 extent 2 over 2, banded", box256,
              ((2,), ("p",)), {}, MXU_VERIFY_RTOL),
             ("jacobi3d 512^3 x 8, p x x 2 x 2 (j over x)", jacobi8,
              ((2, 2), ("p", "x")), {"domain_axes": {1: "x"}}, 0.0)]
    for _label, p, (shape, names), kw, _tol in pipes:
        mesh = make_mesh([cuda], shape, names)
        thunks.append(lambda p=p, m=mesh, kw=kw: compile_pipeline_split(
            p, m, "p", **kw))
    # K4's reduced precisions (their f32 counterparts are the cells above):
    # (kernels-line name, label, program, mesh, options)
    bf16 = [("local_stream_shard_bf16_rings",
             "jacobi3d 512^3 x 8, 2 x 2, ring_storage=bfloat16", jacobi8,
             jk, {"ring_storage": "bfloat16"}),
            ("local_stream_shard_bf16",
             "box3d 256^3 x 8 extent 2, 2 x 2, mxu_precision=bf16", box256,
             jk, {"mxu_precision": "bf16"}),
            ("local_stream_segment_bf16",
             "box3d 256^3 x 8 extent 2 over 2, mxu_precision=bf16", box256,
             ((2,), ("p",), None), {"mxu_precision": "bf16"})]
    for _key, _label, p, (shape, names, axes), kw in bf16:
        mesh = make_mesh([cuda], shape, names)
        thunks.append(
            (lambda p=p, m=mesh, kw=kw: compile_pipeline_split(
                p, m, "p", **kw)) if axes is None else
            (lambda p=p, m=mesh, a=axes, kw=kw: compile_sharded_chain(
                p, m, a, **kw)))
    # the comm/compute overlap over shards of i: (label, program, mesh,
    # tolerance against the blocking call); the blocking engine of each,
    # uncomposed as the overlap is, is built here
    overlap = [("jacobi3d 512^3 x 8, 4 shards of i", jacobi8, i4, 0.0),
               ("box3d 256^3 x 8 extent 2, 2 shards of i", box256,
                ((2,), ("x",), ("x", None, None)), MXU_VERIFY_RTOL)]
    for _label, p, (shape, names, axes), _tol in overlap:
        mesh = make_mesh([cuda], shape, names)
        thunks.append(lambda p=p, m=mesh, a=axes: compile_sharded_chain(
            p, m, a, comm_overlap=True))
        thunks.append(lambda p=p, m=mesh, a=axes: compile_sharded_chain(
            p, m, a, compose="off"))
    # the multi-host legs' kernels, for their processes to find built: a
    # position a process on the (1, 2) ('x', 'y') mesh run-distributed
    # builds for --devices 2, the ("p",) pipeline of 2, and the sharded
    # one-stage step the orbax checkpoint leg iterates on 2 x 2
    m12 = make_mesh([cuda], (1, 2), ("x", "y"))
    j256 = synth("diffusion", 256, 8)
    thunks += [
        lambda: compile_sharded_chain(j256, m12, (None, "x", "y")),
        lambda: compile_sharded_chain(j256, m12, ("y", None, None),
                                      comm_overlap=True),
        lambda: compile_pipeline_split(j256, make_mesh([cuda], (2,),
                                                       ("p",)), "p"),
        lambda: compile_sharded_chain(jacobi8, m12, (None, "x", "y")),
        lambda: compile_sharded_chain(step, make_mesh([cuda], *jk[:2]),
                                      jk[2])]
    return (cells, kcases, solvers, pipes, bf16, overlap), thunks


def _sharded(sft, st, pn, ov, gp, tl, setup, smi):
    """Phase 9: the sharded engine (``compile_sharded_chain``) on meshes of
    virtual shards of the one card: K4 per shard against its plain
    version shard by shard; each cell once with the counts reset just
    before and read just after (K4's shard launches = shards), equal to
    the single-device route, its last shard's K4 against its plain
    version at the main path's shape, then timed (a call, its exchange,
    one shard's K4, the single-device route); sharded ``iterate`` and
    ``fast_value_and_grad`` against their single-device runs.  Returns
    K4 per shard's entry of the kernels line, whose ``max_abs_err`` is
    the largest of K4's errors against its plain version in this
    phase."""
    import torch
    from stencilflow_tpu_torch.backend import compile_chain_best
    from stencilflow_tpu_torch.parallel import compile_sharded_chain
    from stencilflow_tpu_torch.backend import linear
    from stencilflow_tpu_torch.parallel.domain import (_sharded_mxu_assets,
                                                       exchange_bytes,
                                                       place_global_inputs)
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    from stencilflow_tpu_torch.report import Report
    cells, kcases, solvers = setup[:3]
    t_phase = time.perf_counter()
    cuda = torch.device("cuda", 0)
    print("sharded: meshes of virtual shards repeating the one card: the "
          "shards' launches run one after another on its stream, so these "
          "times are not multi-GPU scaling figures", flush=True)

    def mesh_of(shape, names):
        return make_mesh([cuda], shape, names)

    def shard_call(fn, plan, per, c):
        oi, oj, ok = plan.block_origin(c)
        return st.run_local_stream(fn.plan, oi - plan.halo[0], per[c],
                                   st.build_stream(fn.plan), oj, ok,
                                   plan.instance(c))

    # K4 per shard against its plain version, shard by shard
    k_err = 0.0
    for label, p, (shape, names, axes), rtol in kcases:
        fn, plan = compile_sharded_chain(p, mesh_of(shape, names), axes)
        if fn.plan is None:
            raise RuntimeError(f"sharded: {label} fell to the tile body")
        per = fn.exchange(place_global_inputs(
            p, plan, sft.load_input_arrays(p, seed=7)))
        worst = 0.0
        for c in per:
            oi, oj, ok = plan.block_origin(c)
            got = shard_call(fn, plan, per, c)
            want = st.local_stream_plain(fn.plan, oi - plan.halo[0], per[c],
                                         oj, ok, plan.instance(c))
            for o in p.outputs:
                good, err = _compare(got[o].cpu().numpy(),
                                     want[o].cpu().numpy(), rtol)
                worst = max(worst, err)
                if not good:
                    raise RuntimeError(f"sharded: K4 shard {c} of {label} "
                                       f"disagrees with its plain version "
                                       f"({o}: {err})")
        k_err = max(k_err, worst)
        print(f"kernel: local_stream_shard {label}: {len(per)} shards "
              f"{'within MXU_VERIFY_RTOL of' if rtol else 'equal to'} the "
              f"plain version (max_abs_err {worst:.3g}), tile "
              f"{fn.plan.tile}, banded {fn.last_config['mxu_stages']}",
              flush=True)

    entry = None
    launches = 0
    for label, p, (shape, names, axes), rtol in cells:
        mesh = mesh_of(shape, names)
        fn, plan = compile_sharded_chain(p, mesh, axes)
        cfg = fn.last_config
        if cfg["backend"] != "stream":
            raise RuntimeError(f"sharded: {label} fell to {cfg}")
        inputs = sft.load_input_arrays(p, seed=0)
        placed = place_global_inputs(p, plan, inputs)
        single, route = compile_chain_best(p, device="cuda")
        dev_in = {n: torch.as_tensor(np.asarray(v)).to(cuda)
                  if np.ndim(v) else v for n, v in inputs.items()}
        del inputs
        torch.cuda.synchronize()
        for m in (pn, ov, gp, tl):
            m.launches_by["exact"] = 0
        for k in ("exact", "local", "spill", "shard"):
            st.launches_by[k] = 0
        out = fn(placed)
        torch.cuda.synchronize()
        n = st.launches_by["shard"]
        other = (sum(m.launches_by["exact"] for m in (pn, ov, gp, tl, st))
                 + st.launches_by["local"] + st.launches_by["spill"])
        if n != mesh.size or other:
            raise RuntimeError(f"sharded: {label}: K4 launched {n} times "
                               f"for {mesh.size} shards (others {other})")
        launches += n
        ref = single(dev_in)
        worst = 0.0
        for o in p.outputs:
            good, err = _compare(out[o].gather(cuda).cpu().numpy(),
                                 ref[o].reshape(p.raw_dimensions).cpu()
                                 .numpy(), rtol)
            worst = max(worst, err)
            if not good:
                raise RuntimeError(f"sharded: {label} {o} differs from the "
                                   f"single-device route ({err})")
        del out, ref
        ms = _time_ms(lambda: fn(placed), 5)
        x_ms = _time_ms(lambda: fn.exchange(placed), 5)
        per = fn.exchange(placed)
        c = list(per)[-1]
        lib = st.build_stream(fn.plan)   # built in phase 2: a lookup
        k_ms = _time_ms(lambda: st.run_local_stream(
            fn.plan, plan.block_origin(c)[0] - plan.halo[0], per[c], lib,
            *plan.block_origin(c)[1:], plan.instance(c)), 5)
        s_ms = _time_ms(lambda: single(dev_in), 5)
        # the last shard (non-zero origins in every sharded dim) through
        # K4 against its plain version at the main path's shape
        oi, oj, ok = plan.block_origin(c)
        got = shard_call(fn, plan, per, c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = st.local_stream_plain(fn.plan, oi - plan.halo[0], per[c], oj,
                                     ok, plan.instance(c))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        s_err = 0.0
        for o in p.outputs:
            good, err = _compare(got[o].cpu().numpy(),
                                 want[o].cpu().numpy(), rtol)
            s_err = max(s_err, err)
            if not good:
                raise RuntimeError(f"sharded: K4 shard {c} of {label} "
                                   f"disagrees with its plain version "
                                   f"({o}: {err})")
        k_err = max(k_err, s_err)
        del got, want
        xr, xw = exchange_bytes(plan)
        assets = _sharded_mxu_assets(fn.plan, plan)
        pools = (f", per-shard band pool {assets[3]} B, "
                 f"{sum(map(linear.is_stacked_key, assets[0]))} of "
                 f"{len(assets[0])} entries stacked") if assets else ""
        print(f"sharded: {label} ({cfg['backend']}, banded "
              f"{cfg['mxu_stages']}{', composed' if cfg.get('composed') else ''}"
              f"{pools}; block {plan.block}, halo {plan.halo}, tile "
              f"{fn.plan.tile} x {fn.plan.threads}) {ms:.3f} ms a call | K4 "
              f"a shard {k_ms:.3f} ms | exchange {x_ms:.3f} ms, "
              f"{xr / 1e9:.3f} GB read + {xw / 1e9:.3f} GB written | "
              f"single-device {route} {s_ms:.3f} ms | "
              f"{'within MXU_VERIFY_RTOL of' if rtol else 'equal to'} it "
              f"(max_abs_err {worst:.3g}) | K4 launches {n} | K4 shard {c} "
              f"{'within MXU_VERIFY_RTOL of' if rtol else 'equal to'} its "
              f"plain version (max_abs_err {s_err:.3g}, plain "
              f"{plain_ms:.1f} ms) | {smi}", flush=True)
        if entry is None:
            # the kernels line's entry: one shard of the first cell
            cells_in = sum(t.numel() * t.element_size()
                           for name, t in per[c].items()
                           if not p.inputs[name].is_scalar)
            out_bytes = sum(int(np.prod(plan.block)) * np.dtype(
                p.kernels[o].dtype).itemsize for o in p.outputs)
            rep = Report.build(p)
            t_bytes = (cells_in + out_bytes) / rep.hw.hbm_bandwidth * 1e3
            t_ops = rep.alu_time_s() / mesh.size * 1e3
            bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                                  else (t_ops, "operations"))
            wide = tuple(b + 2 * h for b, h in zip(plan.block, plan.halo))
            lib_ms = _conv_chain_ms(p, 1, shape=wide)
            entry = {"name": "local_stream_shard", "route": "cuda",
                     "source": "stencilflow_tpu_torch/backend/codegen.py",
                     "replaces": "stencilflow_tpu/backend/stream.py:1943",
                     "launches": 0, "max_abs_err": 0.0, "ms": k_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms}
            print(f"kernel: local_stream_shard {label}, shard {c} "
                  f"({wide} in, {plan.block} out): {k_ms:.3f} ms, plain "
                  f"version {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}), {len(p.kernels)} chained F.conv3d over "
                  f"the widened shard {lib_ms:.3f} ms | {smi}", flush=True)
        del placed, dev_in, per
        torch.cuda.empty_cache()
    entry.update(launches=launches, max_abs_err=k_err)

    # the solver entry points on a mesh, against their single-device runs
    shape, names, axes = solvers["mesh"]
    mesh = mesh_of(shape, names)
    p = solvers["iterate"]
    inputs = sft.load_input_arrays(p, seed=0)
    stats = {}
    t0 = time.perf_counter()
    got = sft.iterate(p, inputs, 16, fuse=8, mesh=mesh, dim_axes=axes,
                      stats=stats)
    it_s = time.perf_counter() - t0
    want = sft.iterate(p, inputs, 16, fuse=8, device="cuda")
    if stats["backend"] != "sharded[stream]" or not all(
            np.array_equal(got[k], want[k]) for k in want):
        raise RuntimeError(f"sharded: iterate on the mesh ({stats}) differs "
                           "from in-core iterate")
    p = solvers["grad"]
    inputs = sft.load_input_arrays(p, seed=0)
    f = sft.fast_value_and_grad(p, mesh=mesh, dim_axes=axes)
    v1, g1 = f(inputs)
    v2, g2 = sft.fast_value_and_grad(p, device="cuda")(inputs)
    if f.lowering != {"forward": "sharded[stream]",
                      "adjoint": "sharded[stream]"} or not all(
            torch.equal(g1[k], g2[k]) for k in g2):
        raise RuntimeError(f"sharded: fast_value_and_grad on the mesh "
                           f"({f.lowering}) differs from one device")
    print(f"sharded: iterate {solvers['iterate'].name} 16 steps fused by 8 "
          f"on 2 x 2 ({stats['backend']}, {stats.get('captures')} captures, "
          f"{stats.get('replays')} replays, {it_s:.2f} s with its capture) "
          f"equal to in-core iterate; fast_value_and_grad {p.name} on 2 x 2 "
          f"({f.lowering['forward']} + {f.lowering['adjoint']}) equal to "
          f"one device | {smi}", flush=True)
    print(f"sharded: the domain engine took "
          f"{time.perf_counter() - t_phase:.1f} s | {smi}", flush=True)
    return entry


def _overlap(sft, st, pn, ov, gp, tl, setup, smi):
    """Phase 9, continued: the comm/compute overlap
    (``compile_sharded_chain(comm_overlap=True)``) over virtual shards of
    i: jacobi3d 512^3 x 8 over 4 (B0 = 128, h = 8: a 112-plane interior
    K4 and two 8-plane strip K4s a shard) and box3d 256^3 x 8 of extent 2
    over 2 (banded interior and strips).  Each cell driven once with the
    counts reset just before and read just after (K4's shard launches 3 x
    shards, nothing else), then held to the blocking call over 10 more
    calls (bit for bit per cell, MXU_VERIFY_RTOL banded: the interior and
    strip plans sum their bands in their own tiles), timed in turns with
    it (blocking, overlapped, overlapped, blocking) beside the exchange
    alone and the blocking route's call (which composes box's affine
    run: the overlap does not, as the reference's, so the blocking call
    held and timed in turns is the uncomposed one); the first cell's last
    shard's interior and strip K4s against their plain versions and
    timed.  On one card the exchange's side
    stream and the interiors share the card: no scaling figure.  Returns
    the kernels line's entry."""
    import torch
    from stencilflow_tpu_torch.parallel import compile_sharded_chain
    from stencilflow_tpu_torch.parallel.domain import place_global_inputs
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    from stencilflow_tpu_torch.report import Report
    cuda = torch.device("cuda", 0)
    entry, launches, k_err = None, 0, 0.0
    for label, p, (shape, names, axes), rtol in setup[5]:
        mesh = make_mesh([cuda], shape, names)
        fn, plan = compile_sharded_chain(p, mesh, axes, comm_overlap=True)
        block, _ = compile_sharded_chain(p, mesh, axes, compose="off")
        routed, _ = compile_sharded_chain(p, mesh, axes)
        cfg = fn.last_config
        if cfg["backend"] != "stream" or not cfg["comm_overlap"]:
            raise RuntimeError(f"overlap: {label} took {cfg}")
        placed = place_global_inputs(p, plan, sft.load_input_arrays(p,
                                                                    seed=0))
        torch.cuda.synchronize()
        _counts_zero(pn, ov, gp, tl, st)
        out = fn(placed)
        torch.cuda.synchronize()
        counts = _counts(pn, ov, gp, tl, st)
        n = counts.pop("stream:shard", 0)
        if n != 3 * mesh.size or counts:
            raise RuntimeError(f"overlap: {label}: K4 launched {n} times for "
                               f"{mesh.size} shards (others {counts})")
        launches += n
        o = p.outputs[0]
        want = block(placed)[o].gather(cuda).cpu().numpy()
        worst = 0.0
        for _rep in range(11):
            got = (out if _rep == 0 else fn(placed))[o].gather(cuda)
            good, err = _compare(got.cpu().numpy(), want, rtol)
            worst = max(worst, err)
            if not good or not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"overlap: {label} call {_rep} differs "
                                   f"from the blocking call ({err})")
        del out, got
        turns = [_time_ms(lambda f=f: f(placed), 5)
                 for f in (block, fn, fn, block)]
        x_ms = _time_ms(lambda: block.exchange(placed), 5)
        r_ms = _time_ms(lambda: routed(placed), 5)
        ip, sp = fn.plan
        line = ""
        if entry is None:
            # the last shard's interior and strips, each against its plain
            # version, then the three timed one after another
            c = plan.mesh.coords()[-1]
            start, oj, ok = plan.block_origin(c)
            h, B0 = plan.halo[0], plan.block[0]
            raw = {n: v if p.inputs[n].is_scalar else v.shards[c]
                   for n, v in placed.items()}
            wide = block.exchange(placed)[c]
            slabs = [({n: v if p.inputs[n].is_scalar else v.narrow(
                0, lo, 3 * h) for n, v in wide.items()}, origin)
                for lo, origin in ((0, start - h),
                                   (B0 - h, start + B0 - 2 * h))]
            calls = [(ip, start, raw)] + [(sp, org, sl) for sl, org in slabs]
            libs = [st.build_stream(q) for q, _o, _a in calls]
            s_err = 0.0
            plain_ms = 0.0
            for (q, org, arrs), lib in zip(calls, libs):
                got = st.run_local_stream(q, org, arrs, lib, oj, ok,
                                          plan.instance(c))[o]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want_k = st.local_stream_plain(q, org, arrs, oj, ok,
                                               plan.instance(c))[o]
                torch.cuda.synchronize()
                plain_ms += (time.perf_counter() - t0) * 1e3
                good, err = _compare(got.cpu().numpy(),
                                     want_k.cpu().numpy(), rtol)
                s_err = max(s_err, err)
                if not good:
                    raise RuntimeError(f"overlap: {label}: K4 (block "
                                       f"{q.block}) disagrees with its plain "
                                       f"version ({err})")
            k_ms = _time_ms(lambda: [st.run_local_stream(
                q, org, arrs, lib, oj, ok, plan.instance(c))
                for (q, org, arrs), lib in zip(calls, libs)], 5)
            k_err = max(k_err, s_err)
            in_bytes = sum(t.numel() * t.element_size()
                           for _q, _o, arrs in calls
                           for n, t in arrs.items()
                           if not p.inputs[n].is_scalar)
            out_bytes = sum(int(np.prod(plan.block)) * np.dtype(
                p.kernels[q].dtype).itemsize for q in p.outputs)
            rep = Report.build(p)
            t_bytes = (in_bytes + out_bytes) / rep.hw.hbm_bandwidth * 1e3
            t_ops = rep.alu_time_s() / mesh.size * 1e3
            bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                                  else (t_ops, "operations"))
            lib_ms = _conv_chain_ms(p, 1, shape=(B0 + 2 * h,)
                                    + tuple(plan.block[1:]))
            entry = {"name": "local_stream_shard_overlap", "route": "cuda",
                     "source": "stencilflow_tpu_torch/backend/codegen.py",
                     "replaces": "stencilflow_tpu/backend/stream.py:1943",
                     "launches": 0, "max_abs_err": 0.0, "ms": k_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms}
            line = (f" | shard {c}: interior K4 ({ip.block} planes, tile "
                    f"{ip.tile}) + 2 strip K4s ({sp.block} planes, tile "
                    f"{sp.tile}) {k_ms:.3f} ms, plain versions "
                    f"{plain_ms:.1f} ms, max_abs_err {s_err:.3g}, bound "
                    f"{bound_ms:.4f} ms ({bound_by}), {len(p.kernels)} "
                    f"chained F.conv3d over the widened shard "
                    f"{lib_ms:.3f} ms")
            del raw, wide, slabs, calls
        print(f"overlap: {label} (banded {cfg['mxu_stages']}; block "
              f"{plan.block}, halo {plan.halo}) overlapped "
              f"{(turns[1] + turns[2]) / 2:.3f} ms a call (in turns "
              f"{turns[1]:.3f} / {turns[2]:.3f}) | blocking "
              f"{(turns[0] + turns[3]) / 2:.3f} ms ({turns[0]:.3f} / "
              f"{turns[3]:.3f}) | exchange {x_ms:.3f} ms | blocking route "
              f"({'composed' if routed.last_config.get('composed') else 'the same plan'})"
              f" {r_ms:.3f} ms | K4 launches {n} "
              f"= 3 x {mesh.size} shards | 11 calls "
              f"{'within MXU_VERIFY_RTOL of' if rtol else 'equal to'} the "
              f"blocking call (max_abs_err {worst:.3g}){line} | {smi}",
              flush=True)
        del placed, routed
        for q in fn.plan:
            q.device_pool.clear()
        torch.cuda.empty_cache()
    entry.update(launches=launches, max_abs_err=k_err)
    return entry


def _pipeline(sft, st, pn, ov, gp, tl, setup, smi):
    """Phase 9, continued: the pipeline split (``compile_pipeline_split``)
    over meshes repeating the one card.  Each cell once with the counts
    reset just before and read just after (K4's launches = segments x
    chunks; the pipeline x domain cell runs the dense tile body, as the
    reference's, and launches no kernel), equal to the single-device
    route; then timed (a call, the single-device route).  Segment 0 of
    the first cell and of every banded cell through K4 against its plain
    version at the main path's shape; the first cell's timed with its
    plain version and the chained ``F.conv3d`` over the segment's tile.
    Returns K4 per segment's entry of the kernels line, whose
    ``max_abs_err`` is the largest of those segments' errors."""
    import torch
    from stencilflow_tpu_torch.backend import compile_chain_best
    from stencilflow_tpu_torch.parallel import compile_pipeline_split
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    from stencilflow_tpu_torch.report import Report
    pipes = setup[3]
    t_phase = time.perf_counter()
    cuda = torch.device("cuda", 0)
    print("pipeline: positions repeating the one card: segments run one "
          "after another on its stream and a hop copies nothing, so these "
          "times are not multi-GPU figures", flush=True)
    entry, launches, k_err = None, 0, 0.0
    for label, p, (shape, names), kw, rtol in pipes:
        mesh = make_mesh([cuda], shape, names)
        fn, plan = compile_pipeline_split(p, mesh, "p", **kw)
        cfg = fn.last_config
        want_backend = "xla" if kw.get("domain_axes") else "stream"
        if cfg["backend"] != want_backend:
            raise RuntimeError(f"pipeline: {label} took {cfg}")
        inputs = sft.load_input_arrays(p, seed=0)
        dev_in = {n: torch.as_tensor(np.asarray(v)).to(cuda)
                  if np.ndim(v) else v for n, v in inputs.items()}
        del inputs
        single, route = compile_chain_best(p, device="cuda")
        placed = fn.place(dev_in)
        torch.cuda.synchronize()
        for m in (pn, ov, gp, tl):
            m.launches_by["exact"] = 0
        for k in ("exact", "local", "spill", "shard"):
            st.launches_by[k] = 0
        out = fn(placed)
        torch.cuda.synchronize()
        n = st.launches_by["local"] + st.launches_by["spill"]
        other = (sum(m.launches_by["exact"] for m in (pn, ov, gp, tl, st))
                 + st.launches_by["shard"])
        S, C = len(plan.segments), plan.num_chunks
        lines = mesh.size // S
        want_n = 0 if want_backend == "xla" else S * C * lines
        if n != want_n or other:
            raise RuntimeError(f"pipeline: {label}: K4 launched {n} times "
                               f"for {S} segments x {C} chunks (others "
                               f"{other})")
        launches += n
        ref = single(dev_in)
        worst = 0.0
        for o in p.outputs:
            good, err = _compare(out[o].gather(cuda).cpu().numpy(),
                                 ref[o].reshape(p.raw_dimensions).cpu()
                                 .numpy(), rtol)
            worst = max(worst, err)
            if not good:
                raise RuntimeError(f"pipeline: {label} {o} differs from the "
                                   f"single-device route ({err})")
        del out, ref
        ms = _time_ms(lambda: fn(placed), 5)
        s_ms = _time_ms(lambda: single(dev_in), 5)
        seg = ""
        if want_backend == "stream" and (entry is None or rtol):
            # segment 0 on chunk 1 through K4 against its plain version
            # at the main path's shape (the first cell's, timed, and every
            # banded cell's): its slabs are the program inputs' window of
            # chunk + 2 E planes, zero past the domain as the body's
            sp, E = fn.stream_plans[0], plan.widen[0][0]
            lo = plan.chunk - E
            slabs = {n: _i_window(v, lo, plan.chunk + 2 * E)
                     if not p.inputs[n].is_scalar
                     and p.inputs[n].dim_mask[0] else v
                     for n, v in dev_in.items() if n in sp.program.inputs}
            lib = st.build_stream(sp)   # built in phase 2: a lookup
            got = st.run_local_stream(sp, lo, slabs, lib)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = st.local_stream_plain(sp, lo, slabs)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            seg_err = 0.0
            for o in sp.program.outputs:
                good, err = _compare(got[o].cpu().numpy(),
                                     want[o].cpu().numpy(), rtol)
                seg_err = max(seg_err, err)
                if not good:
                    raise RuntimeError(f"pipeline: K4 segment 0 of {label} "
                                       f"disagrees with its plain version "
                                       f"({o}: {err})")
            k_err = max(k_err, seg_err)
        if want_backend == "stream" and entry is not None and rtol:
            banded = cfg["segments"][0]["mxu_stages"]
            seg = (f" | K4 segment 0 (banded {banded}) within "
                   f"MXU_VERIFY_RTOL of its plain version "
                   f"(max_abs_err {seg_err:.3g})")
            del got, want, slabs
        elif want_backend == "stream" and entry is None:
            k_ms = _time_ms(lambda: st.run_local_stream(sp, lo, slabs, lib),
                            5)
            # one cut's carry: what a hop between distinct devices copies
            carry = {f: got[f] for f in fn.cut_layouts[0] if f in got}
            hop_mb = sum(t.numel() * t.element_size()
                         for t in carry.values()) / 1e6
            hop_ms = _time_ms(lambda: [t.clone() for t in carry.values()],
                              5)
            in_bytes = sum(t.numel() * t.element_size()
                           for n, t in slabs.items()
                           if not p.inputs[n].is_scalar)
            out_bytes = sum(t.numel() * t.element_size()
                            for t in got.values())
            rep = Report.build(sp.program)
            t_bytes = (in_bytes + out_bytes) / rep.hw.hbm_bandwidth * 1e3
            t_ops = rep.alu_time_s() * sp.block / p.dimensions[0] * 1e3
            bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                                  else (t_ops, "operations"))
            wide = (sp.extent(),) + tuple(p.dimensions[1:])
            lib_ms = _conv_chain_ms(sp.program, 1, shape=wide)
            entry = {"name": "local_stream_segment", "route": "cuda",
                     "source": "stencilflow_tpu_torch/backend/codegen.py",
                     "replaces": "stencilflow_tpu/backend/stream.py:1943",
                     "launches": 0, "max_abs_err": 0.0, "ms": k_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms}
            seg = (f" | K4 segment 0 ({wide} in, ({sp.block}, "
                   f"{p.dimensions[1]}, {p.dimensions[2]}) out, tile "
                   f"{sp.tile} x {sp.threads}) {k_ms:.3f} ms, plain version "
                   f"{plain_ms:.1f} ms, equal to it (max_abs_err "
                   f"{seg_err:.3g}), "
                   f"bound {bound_ms:.4f} ms ({bound_by}), "
                   f"{len(sp.program.kernels)} chained F.conv3d over its "
                   f"tile {lib_ms:.3f} ms | hop: one cut's carry "
                   f"{hop_mb:.1f} MB, no copy on a repeated card, a device "
                   f"copy of it {hop_ms:.3f} ms")
            del got, want, slabs, carry
        print(f"pipeline: {label} ({cfg['backend']}, {cfg['io']} io, "
              f"segments {[len(x) for x in plan.segments]}, banded "
              f"{[x['mxu_stages'] for x in cfg['segments']]}, chunk "
              f"{plan.chunk}, widen {[w for w in plan.widen]}) "
              f"{ms:.3f} ms a call | single-device {route} {s_ms:.3f} ms | "
              f"{'within MXU_VERIFY_RTOL of' if rtol else 'equal to'} it "
              f"(max_abs_err {worst:.3g}) | K4 launches {n}{seg} | {smi}",
              flush=True)
        del dev_in, placed
        torch.cuda.empty_cache()
    entry.update(launches=launches, max_abs_err=k_err)
    print(f"pipeline: took {time.perf_counter() - t_phase:.1f} s | {smi}",
          flush=True)
    return entry


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_pairs(cmds, timeout: float):
    """Start every command at once (pairs of a multi-host launch), wait
    for all; on a timeout or an error every process is killed.  Returns
    (rc, merged output) a command."""
    procs = [subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = []
    end = time.perf_counter() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, end - time.perf_counter()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _timed_host(stencil_file: str, coordinator: str, host: int,
                device: str = "cuda") -> int:
    """One process of phase 9's timed two-process domain call (spawned
    with ``python -c``, one a host): joins the gloo group, builds the
    global (1, 2) ('x', 'y') mesh, a position a process on ``device``
    (``cli run-distributed --devices 2 --coordinator``'s mesh),
    compiles the sharded chain over ``(None, 'x', 'y')`` and places its
    inputs; then, each rep started together behind a barrier and ended by
    synchronizing the device, times a warm call, then the exchange alone.
    Prints one JSON line: the median ms of a call, of the exchange and of
    the exchange's cross-process rounds (``transport.stats``), the bytes
    this process received a call beside the mesh-scaling model's
    ``ici_bytes_per_device`` (both faces of every sharded dim of a
    position with two neighbours), and the K4 launches of one call."""
    import statistics

    import torch
    import torch.distributed as dist
    from stencilflow_tpu_torch.backend import stream
    from stencilflow_tpu_torch.data import load_input_arrays
    from stencilflow_tpu_torch.frontend.parser import parse_program
    from stencilflow_tpu_torch.parallel import transport
    from stencilflow_tpu_torch.parallel.domain import (compile_sharded_chain,
                                                       place_global_inputs)
    from stencilflow_tpu_torch.parallel.mesh import (make_host_mesh,
                                                     mesh_shape_2d)
    from stencilflow_tpu_torch.report import Report
    axes = (None, "x", "y")
    dev = torch.device(device)
    program = parse_program(stencil_file)
    inputs = load_input_arrays(program, seed=0)
    transport.init_hosts(coordinator, 2, host)
    try:
        shape = mesh_shape_2d(2)
        mesh = make_host_mesh([dev], shape, ("x", "y"), host, 2)
        fn, plan = compile_sharded_chain(program, mesh, axes)
        placed = place_global_inputs(program, plan, inputs)
        del inputs

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        reps = 5

        def timed(call):
            """Median ms of a rep and of its cross-process rounds."""
            ms, rounds = [], []
            for _ in range(reps):
                dist.barrier()
                r0 = transport.stats["seconds"]
                t0 = time.perf_counter()
                call()
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                rounds.append((transport.stats["seconds"] - r0) * 1e3)
            return statistics.median(ms), statistics.median(rounds)

        fn(placed)                       # warm-up: builds, pools, buffers
        sync()
        stream.launches_by.clear()
        fn(placed)
        sync()
        launches = sum(stream.launches_by.values())
        call_ms, _ = timed(lambda: fn(placed))
        transport.stats["bytes_received"] = 0
        x_ms, round_ms = timed(lambda: fn.exchange(placed))
        model = Report.build(program).mesh_scaling(
            dict(zip(("x", "y"), shape)), axes)
        print(json.dumps({
            "host": host, "mesh": dict(mesh.shape),
            "local": len(mesh.local_coords()),
            "backend": fn.last_config["backend"], "k4_launches": launches,
            "call_ms": call_ms, "exchange_ms": x_ms,
            "remote_round_ms": round_ms,
            "bytes_received": transport.stats["bytes_received"] // reps,
            "model_ici_bytes_per_device": model["ici_bytes_per_device"],
            "transport": transport.TRANSPORT}), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _multihost(sft, setup, smi, tmp):
    """Phase 9, continued: the multi-host surfaces.  Two processes of
    ``python -m stencilflow_tpu_torch.cli run-distributed --coordinator
    127.0.0.1:PORT --num-hosts 2 --host-id {0,1} --devices 2
    --compare-to-reference`` on jacobi3d 256^3 x 8, a position a process
    on cuda:0 (K4 a shard or a segment, slabs over gloo through pinned
    host buffers): domain blocking (k over 2), domain ``--comm-overlap``
    (i over 2: interior and strip K4s) and pipeline (2 segments), the
    three pairs at once; each process must exit 0, verify its shards and
    launch K4.  Then one pair of ``_timed_host`` processes (``python
    -c``) on jacobi3d 512^3 x 8 (ms a
    call after a warm-up, the exchange's ms, the bytes a rank received
    beside ``mesh_scaling``'s ``ici_bytes_per_device``).  Both ranks
    share the one card: not a scaling figure.  Then ``iterate`` with
    ``checkpoint_format="orbax"`` over 2 x 2 virtual shards of the card
    (jacobi3d 256^3, 16 steps, a save every chunk of 4): the newest step
    removed, the resume bit-equal to the uninterrupted run, with the
    save's ms and the chunk's wall with and without a save.  Last, the
    mesh-scaling model's line for jacobi3d 512^3 x 8 over 2 x 2 (host
    time only; the exchange at the NVLink data-sheet rate)."""
    import shutil

    import torch
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    from stencilflow_tpu_torch.report import Report
    from stencilflow_tpu_torch.synthesize import synthesize_stencil
    t_phase = time.perf_counter()
    progs = {}
    for n in (256, 512):
        progs[n] = os.path.join(tmp, f"jacobi3d_{n}_8itr.json")
        with open(progs[n], "w") as f:
            json.dump(synthesize_stencil(
                num_stages=8, dimensions=(n,) * 3, shape="diffusion",
                seed_data="random:0.0,1.0"), f)
    legs = [("domain, blocking (k over 2)", ["--dim-axes", "none,x,y"]),
            ("domain, --comm-overlap (i over 2)",
             ["--dim-axes", "y,none,none", "--comm-overlap"]),
            ("pipeline (2 segments)", ["--parallel-mode", "pipeline"])]
    cmds = []
    for _label, extra in legs:
        port = _free_port()
        cmds += [[sys.executable, "-m", "stencilflow_tpu_torch.cli",
                  "run-distributed", progs[256], "--devices", "2",
                  "--coordinator", f"127.0.0.1:{port}", "--num-hosts", "2",
                  "--host-id", str(h), "--compare-to-reference"] + extra
                 for h in range(2)]
    t0 = time.perf_counter()
    got = _spawn_pairs(cmds, 400)
    wall = time.perf_counter() - t0
    for i, (label, _extra) in enumerate(legs):
        seen = []
        for h in range(2):
            rc, out = got[2 * i + h]
            body = [ln for ln in out.splitlines()
                    if ln.startswith(f"host {h}: backend: ")]
            if rc != 0 or f"host {h}: verified local shards: OK" not in out \
                    or not body or "stream" not in body[0] \
                    or body[0].endswith("K4 launches 0"):
                raise RuntimeError(f"multihost: {label}, host {h} (rc {rc}):"
                                   f"\n{out[-3000:]}")
            seen.append(body[0].split(": backend: ", 1)[1])
        print(f"multihost: jacobi3d 256^3 x 8 {label}, 2 processes on "
              f"cuda:0 over gloo: host 0 {seen[0]}, host 1 {seen[1]}, "
              f"both verified their shards OK (the three pairs at once in "
              f"{wall:.1f} s) | {smi}", flush=True)

    port = _free_port()
    got = _spawn_pairs([[sys.executable, "-c",
                         "import sys, chip_smoke; sys.exit(chip_smoke."
                         f"_timed_host({progs[512]!r}, '127.0.0.1:{port}', "
                         f"{h}))"] for h in range(2)], 300)
    rows = []
    for h, (rc, out) in enumerate(got):
        line = [ln for ln in out.splitlines() if ln.startswith("{")]
        if rc != 0 or not line:
            raise RuntimeError(f"multihost: timing host {h} (rc {rc}):\n"
                               f"{out[-3000:]}")
        rows.append(json.loads(line[-1]))
        r = rows[-1]
        if r["backend"] != "stream" or r["k4_launches"] < 1:
            raise RuntimeError(f"multihost: timing host {h}: {r}")
    for r in rows:
        print(f"multihost: timed jacobi3d 512^3 x 8, host {r['host']} of 2 "
              f"(mesh {r['mesh']}, {r['local']} local on cuda:0, K4 "
              f"launches {r['k4_launches']} a call): {r['call_ms']:.3f} ms "
              f"a call (median of 5 after a warm-up), exchange "
              f"{r['exchange_ms']:.3f} ms of which the cross-process round "
              f"{r['remote_round_ms']:.3f} ms, received "
              f"{r['bytes_received']} B a call beside mesh_scaling's "
              f"ici_bytes_per_device {r['model_ici_bytes_per_device']} B "
              f"(both faces; an edge position receives one), over "
              f"{r['transport']}; both ranks share one card: not a "
              f"scaling figure | {smi}", flush=True)

    # sharded asynchronous checkpoints from the CUDA-graph loop
    cuda = torch.device("cuda", 0)
    p = setup[2]["iterate"]
    shape, names, axes = setup[2]["mesh"]
    mesh = make_mesh([cuda], shape, names)
    inputs = sft.load_input_arrays(p, seed=0)
    ck = os.path.join(tmp, "ckpt")
    kw = dict(mesh=mesh, dim_axes=axes, chunk=4)
    # warm: builds, pools, and DCP's imports and writer thread
    sft.iterate(p, inputs, 4, checkpoint_every=4, checkpoint_format="orbax",
                checkpoint_dir=os.path.join(tmp, "warm"), **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = sft.iterate(p, inputs, 16, **kw)
    t_plain = time.perf_counter() - t0
    stats = {}
    t0 = time.perf_counter()
    full = sft.iterate(p, inputs, 16, checkpoint_every=4, checkpoint_dir=ck,
                       checkpoint_format="orbax", stats=stats, **kw)
    t_ck = time.perf_counter() - t0
    steps = sorted(int(d) for d in os.listdir(ck) if d.isdigit())
    shutil.rmtree(os.path.join(ck, "16"))
    again = sft.iterate(p, inputs, 16, checkpoint_every=4,
                        checkpoint_dir=ck, checkpoint_format="orbax", **kw)
    shutil.rmtree(ck)
    if steps != [4, 8, 12, 16] or not (
            np.array_equal(full["a"], again["a"])
            and np.array_equal(full["a"], plain["a"])):
        raise RuntimeError(f"multihost: orbax checkpoints {steps}: the "
                           "resume differs from the uninterrupted run")
    save_ms = [x * 1e3 for x in stats["save_s"]]
    print(f"checkpoint: iterate {p.name} over 2 x 2 virtual shards, 16 "
          f"steps in chunks of 4, checkpoint_format=orbax "
          f"(torch.distributed.checkpoint, one entry a shard, "
          f"{stats['backend']}, {stats['replays']} replays): step "
          f"directories {steps}; with step 16 removed the resume equals "
          f"the uninterrupted run bit for bit; a save's staging and "
          f"submission {np.mean(save_ms):.2f} ms (max {max(save_ms):.2f}), "
          f"{stats['save_wait_s'] * 1e3:.1f} ms waiting for writes in all "
          f"(the last one's at the end); a chunk's wall (the call over 4 "
          f"chunks, its capture included, after a warm call) "
          f"{t_ck / 4 * 1e3:.2f} ms with a save, {t_plain / 4 * 1e3:.2f} ms "
          f"without | {smi}", flush=True)

    jac = sft.parse_program(progs[512], name="jacobi3d_512_8itr")
    m = Report.build(jac).mesh_scaling({"x": 2, "y": 2}, (None, "x", "y"))
    o = m["comm_overlap"]
    print(f"mesh model: jacobi3d 512^3 x 8 over 2 x 2 (None, x, y): local "
          f"block {m['local_dims']}, halo {m['halo']}, "
          f"{m['ici_bytes_per_device']} B a card over NVLink "
          f"({m['t_ici_s'] * 1e6:.1f} us at the data sheet's 450e9 B/s a "
          f"direction), compute {m['t_compute_s'] * 1e6:.1f} us, step "
          f"{m['t_step_s'] * 1e6:.1f} us, {m['scaled_gcell_s']:.1f} GCell/s, "
          f"efficiency {m['parallel_efficiency']:.3f}; overlap step "
          f"{o['t_step_s'] * 1e6:.1f} us ({'wins' if o['wins'] else 'loses'}"
          f", break-even {o['break_even_ici_s'] * 1e6:.1f} us) | {smi}",
          flush=True)
    print(f"multihost: the multi-host, checkpoint and model legs took "
          f"{time.perf_counter() - t_phase:.1f} s | {smi}", flush=True)


def _k4_bf16(sft, st, pn, ov, gp, tl, setup, smi):
    """Phase 9, continued: K4's reduced precisions on meshes repeating the
    one card, each beside its f32 cell (the same program, mesh and
    inputs): bf16 rings in shard mode (jacobi3d 512^3 x 8 over 2 x 2),
    single-pass bf16 passes in shard mode (box3d 256^3 x 8 of extent 2
    over 2 x 2, its per-shard bf16 bands and f32 correction planes) and in
    segment mode (the same box over 2 pipeline positions).  Each leg
    driven once with the counts set to 0 just before and read just after
    (K4's bf16 launches: the shards, or segments x chunks; nothing else),
    its output within BF16_VERIFY_RTOL of its f32 cell's; then its last
    shard (segment 0 on chunk 1) through K4 against its plain version at
    that shape (bf16 rings bit for bit, bf16 passes by
    ``bf16_passes_agree`` against it and the f32 plan's plain version) and
    timed in turns with the f32 cell's kernel on the same tiles (f32,
    bf16, bf16, f32).  Returns the legs' entries of the kernels line."""
    import torch
    from stencilflow_tpu_torch.config import BF16_VERIFY_RTOL
    from stencilflow_tpu_torch.data import arrays_are_equal
    from stencilflow_tpu_torch.parallel import (compile_pipeline_split,
                                                compile_sharded_chain)
    from stencilflow_tpu_torch.parallel.domain import place_global_inputs
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    cuda = torch.device("cuda", 0)
    entries = {}
    for key, label, p, (shape, names, axes), kw in setup[4]:
        t_leg = time.perf_counter()
        mesh = make_mesh([cuda], shape, names)
        segment = axes is None
        mode = kw.get("mxu_precision", "split")
        if segment:
            fn, plan = compile_pipeline_split(p, mesh, "p", **kw)
            f32, _ = compile_pipeline_split(p, mesh, "p")
            splans, f32_plans = fn.stream_plans, f32.stream_plans
        else:
            fn, plan = compile_sharded_chain(p, mesh, axes, **kw)
            f32, _ = compile_sharded_chain(p, mesh, axes)
            splans, f32_plans = [fn.plan], [f32.plan]
        if fn.last_config["backend"] != "stream" or not all(
                st.reduced(sp) for sp in splans):
            raise RuntimeError(f"k4 bf16: {label} took {fn.last_config}")
        inputs = sft.load_input_arrays(p, seed=0)
        dev_in = {n: torch.as_tensor(np.asarray(v)).to(cuda)
                  if np.ndim(v) else v for n, v in inputs.items()}
        placed = fn.place(dev_in) if segment else place_global_inputs(
            p, plan, inputs)
        del inputs
        torch.cuda.synchronize()
        _counts_zero(pn, ov, gp, tl, st)
        out = fn(placed)
        torch.cuda.synchronize()
        counts = _counts(pn, ov, gp, tl, st)
        n = counts.pop("stream:local_bf16" if segment
                       else "stream:shard_bf16", 0)
        want_n = (len(plan.segments) * plan.num_chunks if segment
                  else mesh.size)
        if n != want_n or counts:
            raise RuntimeError(f"k4 bf16: {label}: K4 launched {n} times, "
                               f"expected {want_n} (others {counts})")
        ref = f32(placed)
        o = p.outputs[0]
        got_all = out[o].gather(cuda).cpu().numpy()
        ref_all = ref[o].gather(cuda).cpu().numpy()
        within = arrays_are_equal(ref_all, got_all, BF16_VERIFY_RTOL)
        drift = _rel(got_all, ref_all)
        del out, ref, got_all, ref_all
        ms = _time_ms(lambda: fn(placed), 5)
        f32_ms = _time_ms(lambda: f32(placed), 5)
        # one launch at the main path's shape: the last shard, or segment
        # 0 on chunk 1 (the program inputs' window, as in ``_pipeline``)
        sp, fsp = splans[0], f32_plans[0]
        if segment:
            E = plan.widen[0][0]
            lo = plan.chunk - E
            tiles = {n: _i_window(v, lo, plan.chunk + 2 * E)
                     if not p.inputs[n].is_scalar
                     and p.inputs[n].dim_mask[0] else v
                     for n, v in dev_in.items() if n in sp.program.inputs}
            args, extra = (lo, tiles), ()
        else:
            per = fn.exchange(placed)
            c = list(per)[-1]
            oi, oj, ok = plan.block_origin(c)
            tiles = per[c]
            args, extra = (oi - plan.halo[0], tiles), (oj, ok,
                                                       plan.instance(c))
        lib, flib = st.build_stream(sp), st.build_stream(fsp)   # lookups
        got = st.run_local_stream(sp, *args, lib, *extra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = st.local_stream_plain(sp, *args, *extra)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        so = sp.program.outputs[0]
        if segment:   # the in-domain planes of the segment's block
            g0 = args[0] + sp.halo_i
            win = slice(max(0, -g0), min(sp.block, p.dimensions[0] - g0))
        else:
            win = slice(None)
        far = None
        if mode == "bf16":
            far = st.local_stream_plain(fsp, *args, *extra)[so][win]
            far = far.cpu().numpy()
        ok, err, fig = _bf16_held(got[so][win].cpu().numpy(),
                                  want[so][win].cpu().numpy(), far)
        out_bytes = sum(t.numel() * t.element_size() for t in got.values())
        del got, want, far
        turns = [_time_ms(lambda q=q, lb=lb: st.run_local_stream(
            q, *args, lb, *extra), 5) for q, lb in (
                (fsp, flib), (sp, lib), (sp, lib), (fsp, flib))]
        k_ms, k_f32 = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        in_bytes = sum(t.numel() * t.element_size() for n, t in tiles.items()
                       if n in sp.program.inputs
                       and not sp.program.inputs[n].is_scalar)
        # a segment's work: its stages over its block's planes
        bound_ms, bound_by = _share_bound(
            sp.program if segment else p, in_bytes, out_bytes,
            sp.block / p.dimensions[0] if segment else 1 / mesh.size, mode)
        where = "segment 0, chunk 1" if segment else f"shard {c}"
        print(f"k4 bf16: {label} ({'segments' if segment else 'shards'} "
              f"{len(splans) if segment else mesh.size}, tile {sp.tile} x "
              f"{sp.threads}, smem {sp.smem_bytes()} B, rounded rings "
              f"{sorted(sp.rounds)}, banded {sorted(sp.mxu_plans)}"
              f"{', ' + _routes(sp) + ' bf16 passes' if sp.tkeys else ''}) "
              f"{ms:.3f} ms a call, the f32 cell {f32_ms:.3f} | from it: max "
              f"diff {drift:.3g} of the largest output "
              f"({'within' if within else 'OUTSIDE'} BF16_VERIFY_RTOL) | "
              f"K4 bf16 launches {n} | "
              f"{where}: {k_ms:.3f} ms (in turns {turns[1]:.3f} / "
              f"{turns[2]:.3f}), f32 {k_f32:.3f} ms (in turns "
              f"{turns[0]:.3f} / {turns[3]:.3f}), plain version "
              f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"max_abs_err {err:.3g} {'OK' if ok else 'MISMATCH'} "
              f"{_held_text(fig)} | leg {time.perf_counter() - t_leg:.1f} s"
              f" | {smi}", flush=True)
        if not ok:
            raise RuntimeError(f"k4 bf16: {label}: K4 disagrees with its "
                               "plain version")
        if not within:
            raise RuntimeError(f"k4 bf16: {label} is not within "
                               "BF16_VERIFY_RTOL of its f32 cell")
        entries[key] = {"name": key, "route": "cuda",
                        "source": "stencilflow_tpu_torch/backend/codegen.py",
                        "replaces": "stencilflow_tpu/backend/stream.py:1943",
                        "launches": n, "max_abs_err": err, "ms": k_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None}
        del dev_in, placed, tiles
        torch.cuda.empty_cache()
    return entries


def _design_probes(ov, smi):
    """Phase 6, continued: P6, P3, P2 and P5 against their plain versions
    at a ragged and at the main shape (bit-exact; P6's out and acc, P3's
    ring == direct == plain for every S, P2 in every variant, P5 in every
    walk), P5 beside K2 on the shared program, then one timed case per
    probe, each with its count reset just before and read just after.
    Returns their entries of the kernels line."""
    import torch
    from stencilflow_tpu_torch.probes import async_ring as ar
    from stencilflow_tpu_torch.probes import dma_overlap as do
    from stencilflow_tpu_torch.probes import pingpong_ms, roofline
    from stencilflow_tpu_torch.probes import stateless_panel as sp
    from stencilflow_tpu_torch.probes import table_read as tr
    gen = torch.Generator("cuda").manual_seed(0)

    def rand(shape):
        return torch.rand(shape, device="cuda", generator=gen) * 0.5 + 0.5

    worst = {}

    def same(probe, label, got, want):
        err = float((got - want).abs().max())
        worst[probe] = max(worst.get(probe, 0.0), err)
        if not torch.equal(got, want):
            raise RuntimeError(f"{label} disagrees with its plain version: "
                               f"max abs diff {err:.3g}")

    # P6 and P3: ragged (float4 and scalar units) and main shapes
    for shape in ((45, 37, 200), (13, 19, 37), do.MAIN):
        x = rand(shape)
        for mode in do.MODES:
            want, want_acc = do.overlap_plain(x, mode, 16)
            for bps in (1, 2, 0):
                out, acc = do.overlap(x, mode, 16, blocks_per_sm=bps)
                torch.cuda.synchronize()
                same("dma_overlap", f"dma_overlap {mode}-16 {shape} "
                     f"{bps}/SM", out, want)
                if mode == "indep":
                    same("dma_overlap", f"dma_overlap indep acc {shape}",
                         acc, want_acc)
        want = ar.ring_plain(x, 16)
        for mode, slots in ar.cases():
            for bps in (1, 2, 0):
                got = ar.ring(x, 16, mode, slots, blocks_per_sm=bps)
                torch.cuda.synchronize()
                same("async_ring", f"async_ring {mode} S={slots} {shape} "
                     f"{bps}/SM", got, want)
        del x, want, want_acc, out, acc, got
    # P2: the TPU's shape, a ragged one, the timed one
    for shape in (tr.PARITY, dict(ntab=33, noff=33, rows=5, cols=37,
                                  steps=41), tr.TIMED):
        tab, x = tr.inputs(shape["ntab"], shape["noff"], shape["rows"],
                           shape["cols"], device="cuda")
        want = tr.table_read_plain(tab, x, shape["steps"])
        for v in tr.VARIANTS:
            got = tr.table_read(tab, x, shape["steps"], v)
            torch.cuda.synchronize()
            same("table_read", f"table_read {v} {shape}", got, want)
    # P5: every walk, ragged and main; K2 on the shared program
    for shape in ((37, 45, 70), sp.MAIN):
        x = rand(shape)
        want = sp.panel_plain(x)
        for walk in sp.WALKS:
            for _ in range(1 if walk == "box" else sp.PERSIST_CHECKS):
                got = sp.panel(x, torch.full_like(x, float("nan")),
                               walk=walk)
                torch.cuda.synchronize()
                same("stateless_panel", f"stateless_panel {walk} {shape}",
                     got, want)
    k2 = sp.overlap_k2(sp.MAIN)
    k2_out = k2(x)
    torch.cuda.synchronize()
    same("stateless_panel", "K2 on P5's program", k2_out, want)
    del k2_out, got, want
    print(f"compare: P6 dep/indep, P3 direct and ring S={ar.SLOTS} at 1, 2 "
          f"and all blocks per SM, P2 {tr.VARIANTS}, P5 {sp.WALKS}: ragged "
          f"and main shapes bit-exact; K2 equal to P5 on "
          f"{sp.MAIN} | {smi}", flush=True)

    entry = dict(route="cuda", library_ms=None,
                 launches_counted="eager launches and graph captures; "
                 "replays not counted")
    out = {}
    # one timed case per probe at its main shape
    a, b = x, torch.empty_like(x)
    do.launches = 0
    ms = pingpong_ms(lambda s, d: do.overlap(s, "dep", 16, d), a, b, 3)
    n = do.launches
    out["dma_overlap"] = dict(
        entry, name="dma_overlap",
        source="stencilflow_tpu_torch/csrc/probes/dma_overlap.cu",
        replaces="scripts/dma_overlap_probe.py:56", launches=n, ms=ms,
        max_abs_err=worst["dma_overlap"],
        case="dep N=16, all blocks per SM",
        plain_ms=_time_ms(lambda: do.overlap_plain(a, "dep", 16), 3),
        **{k: v for k, v in roofline(*do.work(do.MAIN, "dep", 16), ms)
           .items() if k in ("bound_ms", "bound_by")})
    ar.launches = 0
    ms = pingpong_ms(lambda s, d: ar.ring(s, 16, "ring", 4, d,
                                          blocks_per_sm=1), a, b, 3)
    n = ar.launches
    out["async_ring"] = dict(
        entry, name="async_ring",
        source="stencilflow_tpu_torch/csrc/probes/dma_overlap.cu",
        replaces="scripts/dma_manual_probe.py:96", launches=n, ms=ms,
        max_abs_err=worst["async_ring"],
        case="ring S=4 N=16, 1 block per SM",
        plain_ms=_time_ms(lambda: ar.ring_plain(a, 16), 3),
        **{k: v for k, v in roofline(*do.work(do.MAIN, "dep", 16), ms)
           .items() if k in ("bound_ms", "bound_by")})
    tr.launches = 0
    rows = tr.measure(trials=3)
    n = tr.launches
    tab, x2 = tr.inputs(*(tr.TIMED[k] for k in ("ntab", "noff", "rows",
                                                "cols")), device="cuda")
    out["table_read"] = dict(
        entry, name="table_read",
        source="stencilflow_tpu_torch/csrc/probes/table_read.cu",
        replaces="scripts/smem_table_probe.py:39", launches=n,
        max_abs_err=worst["table_read"],
        ms=rows[0]["ms"], case="ldg, 33 x 33 table, 256 steps of 256^2",
        variants_ms={r["variant"]: r["ms"] for r in rows},
        plain_ms=_time_ms(lambda: tr.table_read_plain(
            tab, x2, tr.TIMED["steps"]), 3),
        bound_ms=rows[0]["bound_ms"], bound_by=rows[0]["bound_by"])
    sp.launches = 0
    ms = pingpong_ms(lambda s, d: sp.panel(s, d), a, b, 3)
    n = sp.launches
    ov_before = ov.launches_by["exact"]
    k2_ms = sp.k2_ms(k2, a, 3)      # timed as P5 is: graphs, fed back
    k2_n = ov.launches_by["exact"] - ov_before
    out["stateless_panel"] = dict(
        entry, name="stateless_panel",
        source="stencilflow_tpu_torch/csrc/probes/stateless_panel.cu",
        replaces="scripts/stateless_panel_probe.py:82", launches=n, ms=ms,
        max_abs_err=worst["stateless_panel"],
        case=f"B={sp.DEFAULT['B']} tile {sp.DEFAULT['tile']} "
             f"{sp.DEFAULT['walk']}",
        plain_ms=_time_ms(lambda: sp.panel_plain(a), 3),
        library_ms=sp.library_ms(a), k2_ms=k2_ms,
        **{k: v for k, v in roofline(8.0 * a.numel(), 14.0 * a.numel(), ms)
           .items() if k in ("bound_ms", "bound_by")})
    for e in out.values():
        print(f"kernel: {e['name']} ({e['case']}): {e['ms']:.4f} ms, plain "
              f"version {e['plain_ms']:.4f} ms, library "
              f"{'none' if e['library_ms'] is None else '%.4f ms' % e['library_ms']}"
              f", bound {e['bound_ms']:.4f} ms ({e['bound_by']}), launches "
              f"{e['launches']} | {smi}", flush=True)
    print(f"probe: P2 variants {out['table_read']['variants_ms']} ms | P5 "
          f"beside K2 (tile {k2.plan.tile}, {k2_n} launches) "
          f"{k2_ms:.4f} ms | {smi}", flush=True)
    del a, b, x, x2, tab
    torch.cuda.empty_cache()
    return out


# -- programs typed bfloat16 and float16 (K1, K2, K3a, K3c, K5) -------------

NARROW_REPLACES = {"panel": "stencilflow_tpu/backend/panel.py:611",
                   "overlap": "stencilflow_tpu/backend/overlap.py:411",
                   "stream": "stencilflow_tpu/backend/stream.py:1683",
                   "group": "stencilflow_tpu/backend/group.py:695"}


def _narrow_pair_spec(dims):
    """bf16 meeting f16 at ufunc sites (+, *, max, a comparison): each
    pair computes in float32, as ml_dtypes' loops do; a float32 and a
    bf16 output."""
    bc = {"a": {"type": "constant", "value": 0.3}}
    return {"inputs": {"a": {"data": "random:-2,3", "data_type": "bfloat16"},
                       "b": {"data": "random:-2,3", "data_type": "float16"}},
            "outputs": ["s", "t"], "dimensions": list(dims),
            "program": {
                "s": {"computation_string":
                      "s = a[i,j,k] + b[i,j+1,k] * 0.5 - "
                      "max(a[i,j,k-1], b[i,j,k])",
                      "boundary_conditions": dict(bc, b={"type": "copy"}),
                      "data_type": "float32"},
                "t": {"computation_string":
                      "t = a[i-1,j,k] * b[i,j,k] + s[i,j,k] if "
                      "a[i,j,k] > b[i,j,k] else a[i,j,k] / b[i,j-1,k]",
                      "boundary_conditions": dict(
                          bc, b={"type": "constant", "value": 1.5},
                          s={"type": "copy"}),
                      "data_type": "bfloat16"}}}


def _narrow_weak_spec(dims):
    """A float32 stage reading a bf16 stage and an int32 and a bool one:
    weak constants pinned, a bf16 field promoted to float32."""
    return {"inputs": {"f": {"data": "random:0,9", "data_type": "int32"},
                       "b": {"data": "random:0,3", "data_type": "bfloat16"}},
            "outputs": ["s"], "dimensions": list(dims),
            "program": {
                "m": {"computation_string":
                      "m = (f[i,j,k] > 2 and f[i,j,k-1] > 1)",
                      "boundary_conditions":
                      {"f": {"type": "constant", "value": 0}},
                      "data_type": "bool"},
                "w": {"computation_string":
                      "w = (b[i,j,k] + b[i,j+1,k]) * 0.5",
                      "boundary_conditions":
                      {"b": {"type": "constant", "value": 1.0}},
                      "data_type": "bfloat16"},
                "s": {"computation_string":
                      "s = ((1.0 if m[i,j,k] else 0.3) + w[i,j,k]) * 1000 "
                      "+ (f[i,j,k] and f[i+1,j,k])",
                      "boundary_conditions":
                      {"m": {"type": "constant", "value": 0},
                       "w": {"type": "constant", "value": 0.5},
                       "f": {"type": "constant", "value": 0}},
                      "data_type": "float32"}}}


def _narrow_plan(sft, pn, ov, gp, st, codegen, kind: str, p, kw=None):
    """(analysis, plan, source) of a narrow case as its entry point plans
    it (the group kernel at the main path's g = 8, B = 64)."""
    an = sft.ChainAnalysis.run(p)
    if kind == "panel":
        plan = pn.PanelPlan.build(an)
        return an, plan, codegen.panel_source(p, an, plan)
    if kind == "overlap":
        plan = ov.OverlapPlan.build(an)
        return an, plan, codegen.overlap_source(p, an, plan)
    if kind == "group":
        plan = gp.plan_group(p, an, 64, 8)
        return an, plan, codegen.group_source(p, an, plan)
    plan = st.plan_stream(p, an, **(kw or {}))
    return an, plan, st.stream_source(plan)


def _narrow_kernel(pn, ov, gp, st, kind: str, p, an, plan):
    """(run(arrays, lib), plain(arrays), narrow launch count) of a case."""
    if kind == "panel":
        return (lambda a, lib: pn.run_panel(p, an, plan, a, lib),
                lambda a: pn.panel_plain(p, an, plan, a),
                lambda: pn.launches_by["narrow"])
    if kind == "overlap":
        return (lambda a, lib: ov.run_overlap(p, an, plan, a, lib),
                lambda a: ov.overlap_plain(p, an, plan, a),
                lambda: ov.launches_by["narrow"])
    if kind == "group":
        return (lambda a, lib: gp.run_group(p, an, plan, a, lib),
                lambda a: gp.group_plain(p, an, plan, a),
                lambda: gp.launches_by["narrow"])
    return (lambda a, lib: st.run_stream(plan, a, lib),
            lambda a: st.stream_plain(plan, a),
            lambda: (st.launches_by["spill_narrow"] if plan.packed
                     else st.launches_by["narrow"]))


def _narrow_zero(pn, ov, gp, st):
    for m in (pn, ov, gp, st):
        m.launches_by["narrow"] = 0
    st.launches_by["spill_narrow"] = 0


def _narrow_setup(sft, pn, ov, gp, st, codegen, rows, synthesize_stencil,
                  small):
    """Phase 2's share of the narrow legs: phase 3's small cases of each
    kernel on bf16 and f16, two mixed bf16 programs and bf16 meeting f16
    (K1), phase 4's five
    full-width rows, each planned as its entry point plans it.  Returns
    (small cases, full-width rows, sources to build)."""
    from stencilflow_tpu_torch.synthesize import narrow_mixed_spec
    def typed(shape, dims, iters, dt):
        tag = "bf16" if dt == "bfloat16" else "f16"
        return sft.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=dims, shape=shape,
            seed_data="random:0.0,1.0", data_type=dt),
            name=f"{shape}{len(dims)}d_{dims[0]}_{iters}itr_{tag}")
    cases = []
    for dt in ("bfloat16", "float16"):
        tag = "bf16" if dt == "bfloat16" else "f16"
        for label, kind, p, kw in (
                (f"K1 hdiff3d {tag}", "panel", typed("hdiff", small, 3, dt),
                 None),
                (f"K2 jacobi3d {tag}", "overlap",
                 typed("diffusion", small, 2, dt), None),
                (f"K3a jacobi3d {tag}", "stream",
                 typed("diffusion", small, 4, dt), {"mxu": "off"}),
                (f"K3c jacobi3d {tag}", "stream",
                 typed("diffusion", (64, 64, 64), 3, dt), {"spill": "all"}),
                (f"K5 jacobi2d rows {tag}", "group",
                 rows(typed("diffusion", (256, 192), 8, dt)), None)):
            cases.append((label, kind, p, kw) + _narrow_plan(
                sft, pn, ov, gp, st, codegen, kind, p, kw))
    for label, kind, spec, kw in (
            ("K1 mixed bf16", "panel", narrow_mixed_spec(small), None),
            ("K1 bf16 meets f16", "panel", _narrow_pair_spec(small), None),
            ("K3a weak-const bf16", "stream", _narrow_weak_spec(small),
             {"mxu": "off"})):
        p = sft.parse_program(spec, name=label.replace(" ", "_"))
        cases.append((label, kind, p, kw) + _narrow_plan(
            sft, pn, ov, gp, st, codegen, kind, p, kw))
    # jacobi3d 512^3 x 4 (x 8 until the K4 and K6 narrow legs joined the
    # script: its time)
    jacobi4 = {dt: typed("diffusion", (512,) * 3, 4, dt)
               for dt in ("bfloat16", "float16")}
    # (key, kernel, program, run_program backend, its route, repetitions)
    legs = [("panel_typed_bf16", "panel", jacobi4["bfloat16"], "auto",
             "panel"),
            ("panel_typed_f16", "panel", jacobi4["float16"], "auto",
             "panel"),
            ("overlap_typed_bf16", "overlap",
             typed("diffusion", (512,) * 3, 2, "bfloat16"), "auto",
             "overlap"),
            ("stream_typed_bf16", "stream", jacobi4["bfloat16"], "stream",
             "stream"),
            ("group_typed_bf16", "group",
             typed("diffusion", (8192, 8192), 8, "bfloat16"), "auto",
             "rows+group_g8")]
    mains = []
    for key, kind, p, backend, route in legs:
        q = rows(p) if kind == "group" else p
        mains.append((key, kind, p, backend, route, q) + _narrow_plan(
            sft, pn, ov, gp, st, codegen, kind, q))
    sources = [(c[-1], c[1]) for c in cases] + [(m[-1], m[1])
                                                for m in mains]
    return cases, mains, sources


def _narrow_small(sft, pn, ov, gp, st, cases, lib_of, smi):
    """Phase 3's narrow cases: each kernel against its plain version on
    the card, bit for bit (within VERIFY_RTOL where a transcendental
    appears), and against the host oracle, bit for bit (within one bf16
    ulp, 2^-7 relative, where a transcendental appears: the card's expf
    is not the host's, and a one-ulp float32 difference that crosses a
    bf16 rounding point moves the result by a bf16 ulp); the launch
    counted in its narrow count.  Returns K3c bf16's entry of
    the kernels line (no main-path cell reaches the spill rung on a narrow
    program), timed here with its plain version and its library call and
    driven once through its entry point, the count set to 0 just before
    and read just after."""
    import torch
    from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
    from stencilflow_tpu_torch.cardcheck import narrow_held
    from stencilflow_tpu_torch.config import VERIFY_RTOL
    from stencilflow_tpu_torch.dtypes import to_numpy, to_torch
    entry = None
    for label, kind, p, kw, an, plan, src in cases:
        run, plain, count = _narrow_kernel(pn, ov, gp, st, kind, p, an,
                                           plan)
        lib = lib_of[src]
        inputs = sft.load_input_arrays(p, seed=7)
        arrays = spanned_arrays(p, inputs, device="cuda")
        before = count()
        got = run(arrays, lib)
        torch.cuda.synchronize()
        n = count() - before
        t0 = time.perf_counter()
        want = plain(arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        oracle = sft.run_interpreter(p, inputs)
        tr = _has_transcendental(p)
        rtol = VERIFY_RTOL if tr else 0.0
        ms = _time_ms(lambda: run(arrays, lib), 5)
        for o in p.outputs:
            g = to_numpy(got[o])
            ok, err = narrow_held(g, to_numpy(want[o]), rtol)
            ok_o, err_o = narrow_held(g, oracle[o], 2.0 ** -7 if tr
                                       else 0.0)
            print(f"compare: narrow  {label:28s} {kind} "
                  f"{'packed, spilled %d rings ' % len(plan.spilled) if getattr(plan, 'packed', False) else ''}"
                  f"{o} max_abs_err {err:.3g} (oracle {err_o:.3g}) launches "
                  f"{n} {'OK' if ok and ok_o else 'MISMATCH'} "
                  f"{'(within VERIFY_RTOL, oracle one bf16 ulp)' if tr else '(bit-exact)'} | "
                  f"{ms:.4f} ms, plain version {plain_ms:.1f} ms", flush=True)
            if not (ok and ok_o) or n != 1:
                raise RuntimeError(f"narrow {kind} kernel ({label}) "
                                   "disagrees with its plain version or the "
                                   "oracle")
        if label != "K3c jacobi3d bf16":
            continue
        # K3c bf16's row: the leg through its entry point
        fn = st.compile_chain_stream(p, **kw)
        _narrow_zero(pn, ov, gp, st)
        leg = fn({k: v if p.inputs[k].is_scalar else to_torch(v, "cuda")
                  for k, v in inputs.items()})
        torch.cuda.synchronize()
        launches = st.launches_by["spill_narrow"]
        same = all(torch.equal(leg[o].reshape(got[o].shape).view(
            torch.int16), got[o].view(torch.int16)) for o in p.outputs)
        bound_ms, bound_by = _bound(p)
        lib_ms = _conv_chain_ms(p, 1, dtype=torch.bfloat16)
        print(f"kernel: stream_spill_typed_bf16 {p.name} tile {plan.tile} x "
              f"{plan.threads}, smem {plan.smem_bytes()} B, spilled "
              f"{len(plan.spilled)} of {len(plan.raw_ring)} rings: "
              f"{ms:.4f} ms | plain version {plain_ms:.1f} ms | bound "
              f"{bound_ms:.4f} ms ({bound_by}) | {len(p.kernels)} chained "
              f"F.conv3d in bf16 {lib_ms:.4f} ms | leg: "
              f"compile_chain_stream(spill='all') launches {launches}, "
              f"equal to the kernel: {'yes' if same else 'NO'} | {smi}",
              flush=True)
        if launches != 1 or not same:
            raise RuntimeError("the narrow K3c leg did not run its kernel "
                               "once or disagrees with it")
        entry = {"name": "stream_spill_typed_bf16", "route": "cuda",
                 "source": "stencilflow_tpu_torch/backend/codegen.py",
                 "replaces": NARROW_REPLACES["stream"],
                 "launches": launches, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": lib_ms}
        del fn, leg
    return entry


def _loads(plan) -> str:
    """How a narrow plan loads its 2-byte ring inputs: by ``cp.async``
    groups where it aligns them (``copy_groups``: K1, K3a, K4), else
    synchronously (a plan decision, not a fallback)."""
    groups = getattr(plan, "copy_groups", {})
    if not groups:
        return "2-byte inputs loaded synchronously"
    return "2-byte inputs by cp.async of " + ", ".join(
        f"{g} cells ({f})" for f, g in sorted(groups.items()))


def _narrow_legs(sft, pn, ov, gp, st, run_program, mains, lib_of, smi):
    """Phase 4's narrow rows at full width: jacobi3d 512^3 x 4 typed bf16
    and f16 (K1), jacobi3d 512^3 x 2 bf16 (K2), jacobi3d 512^3 x 4 bf16
    with ``--backend stream`` (K3a) and jacobi2d 8192^2 x 8 bf16
    (rows+group_g8, K5).  Each drives ``run_program`` with the narrow
    counts set to 0 just before and read just after (the route must be
    the kernel's), then holds the kernel to its plain version on the same
    inputs on the card bit for bit and to the main path's output, and
    times both and one chained ``F.conv3d``/``conv2d`` in the program's
    type.  Returns the kernels line's entries."""
    import torch
    from stencilflow_tpu_torch.cardcheck import narrow_held
    from stencilflow_tpu_torch.dtypes import to_numpy, to_torch_dtype
    out = {}
    for key, kind, p, backend, route, q, an, plan, src in mains:
        o = p.outputs[0]
        t_cell = time.perf_counter()
        _narrow_zero(pn, ov, gp, st)
        res = run_program(p, device="cuda", backend=backend, repetitions=10,
                          save_results=False, log_level=0)
        run, plain, count = _narrow_kernel(pn, ov, gp, st, kind, q, an,
                                           plan)
        launches = count()
        if res.backend != route or launches != 11:
            raise RuntimeError(f"{key}: backend {res.backend} launched "
                               f"{launches} times over 11 calls, expected "
                               f"{route}")
        main_out, main_ms = res.outputs[o], res.wall_time_s * 1e3
        del res
        lib = lib_of[src]
        arrays = _spanned_on_card(sft, q)
        got = run(arrays, lib)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        g = to_numpy(got[o])
        ok, err = narrow_held(g, to_numpy(want[o]), 0.0)
        same = narrow_held(g, np.asarray(main_out).reshape(g.shape),
                            0.0)[0]
        del got, want, main_out
        ms = _time_ms(lambda: run(arrays, lib), 10)
        del arrays
        torch.cuda.empty_cache()
        dt = to_torch_dtype(p.field_dtype(o))
        lib_ms = _conv_chain_ms(p, 1, dtype=dt)
        torch.cuda.empty_cache()
        bound_ms, bound_by = _bound(p)
        extra = (f"smem {plan.smem_bytes(q)} B"
                 if kind in ("panel", "overlap", "group")
                 else f"smem {plan.smem_bytes()} B")
        print(f"kernel: {key} {p.name} {route} tile {plan.tile} x "
              f"{plan.threads}, {extra}, {_loads(plan)}: {ms:.3f} ms "
              f"({p.total_elements / ms / 1e6:.2f} GCell/s) | main path "
              f"{main_ms:.3f} ms, launches {launches}, "
              f"{'equal to the kernel' if same else 'DIFFERS'} | plain "
              f"version {plain_ms:.1f} ms, max_abs_err {err:.3g} "
              f"{'bit-equal' if ok else 'MISMATCH'} | bound "
              f"{bound_ms:.4f} ms ({bound_by}, 2 B a cell) | "
              f"{len(p.kernels)} chained F.conv{len(p.raw_dimensions)}d in "
              f"{str(dt).split('.')[-1]} {lib_ms:.3f} ms | cell "
              f"{time.perf_counter() - t_cell:.1f} s | {smi}", flush=True)
        if not ok or not same:
            raise RuntimeError(f"{key}: the narrow kernel disagrees with its "
                               "plain version or the main path")
        out[key] = {"name": key, "route": "cuda",
                    "source": "stencilflow_tpu_torch/backend/codegen.py",
                    "replaces": NARROW_REPLACES[kind],
                    "launches": launches, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms}
    return out


# -- programs typed bfloat16 and float16 on K4 and K6, the entry points above
#    them, and float16 compute ----------------------------------------------

K4_REPLACES = "stencilflow_tpu/backend/stream.py:1943"
K6_REPLACES = "stencilflow_tpu/backend/pallas.py:254"
NARROW_TYPES = ("bfloat16", "float16")


def _nk_tag(dt: str) -> str:
    return "bf16" if dt == "bfloat16" else "f16"


def _nk_setup(sft, st, tl, synthesize_stencil):
    """Phase 2's share of the narrow K4 and K6 legs, each planned as its
    entry point plans it: phase 3's small case (hdiff3d 64^3 x 3 typed f16:
    K4 at 4 chunks, K6 fast), phase 4's K6 cells (jacobi3d 512^3 x 2, both
    types, both modes), phase 5's out-of-core cell (jacobi3d 1024^3 x 8
    bf16 at 8 chunks), phase 7's solver programs (jacobi3d 512^3 bf16 fused
    by 8, jacobi3d 256^3 x 8 bf16 and its adjoint, backward Euler 512^3
    f16) and phase 9's cell (jacobi3d 512^3 x 8 bf16 over 2 x 2 and over 4
    positions).  Returns (setup, sources to build, thunks that build
    through the entry points)."""
    import torch
    from stencilflow_tpu_torch.backend import compile_chain_best
    from stencilflow_tpu_torch.cardcheck import local_plan
    from stencilflow_tpu_torch.grad import adjoint_program
    from stencilflow_tpu_torch.iterate import compose_iterations
    from stencilflow_tpu_torch.parallel import (compile_pipeline_split,
                                                compile_sharded_chain)
    from stencilflow_tpu_torch.parallel.mesh import make_mesh
    from stencilflow_tpu_torch.solver_cells import implicit_diffusion

    def typed(shape, n, iters, dt):
        return sft.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=(n,) * 3, shape=shape,
            seed_data="random:0.0,1.0", data_type=dt),
            name=f"{shape}3d_{n}_{iters}itr_{_nk_tag(dt)}")
    cuda = torch.device("cuda", 0)
    jk = make_mesh([cuda], (2, 2), ("x", "y"))
    p4 = make_mesh([cuda], (4,), ("p",))
    hdiff_f16 = typed("hdiff", 64, 3, "float16")
    small = [("chunk", hdiff_f16, local_plan(hdiff_f16, 4)),
             ("fast", hdiff_f16, tl.plan_tile(hdiff_f16, mode="fast"))]
    sources = [(st.stream_source(small[0][2]), "local_stream"),
               (tl.tile_source(small[1][2]), "tile")]
    thunks = []
    tiles = {}
    for dt in NARROW_TYPES:
        p = typed("diffusion", 512, 2, dt)
        for mode in ("fast", "masked"):
            tiles[dt, mode] = (p, tl.plan_tile(p, mode=mode))
            sources.append((tl.tile_source(tiles[dt, mode][1]), "tile"))
    oc = typed("diffusion", 1024, 8, "bfloat16")
    oc_plan = local_plan(oc, 8)
    sources.append((st.stream_source(oc_plan), "local_stream"))
    dist = typed("diffusion", 512, 8, "bfloat16")
    thunks += [lambda: compile_sharded_chain(dist, jk, (None, "x", "y")),
               lambda: compile_pipeline_split(dist, p4, "p")]
    step = typed("diffusion", 512, 1, "bfloat16")
    grad = typed("diffusion", 256, 8, "bfloat16")
    euler = implicit_diffusion(512, dtype="float16")
    for q in (oc, dist, compose_iterations(step, 8), grad,
              adjoint_program(grad)[0], euler):
        thunks.append(lambda q=q: compile_chain_best(q, device="cuda"))
    setup = {"small": small, "tiles": tiles, "oc": (oc, 8, oc_plan),
             "dist": (dist, jk, p4), "solvers": (step, grad, euler)}
    return setup, sources, thunks


def _nk_small(sft, st, tl, small, lib_of, smi):
    """Phase 3's narrow K4 and K6 case (the wider matrix of types, shapes
    and shards runs in tests/test_torch_cuda.py): K4 chunk by chunk at 4
    chunks and K6 fast on hdiff3d 64^3 x 3 typed f16, every launch against
    its plain version on the card bit for bit and counted under its
    narrow mode ("local_narrow", K6's "narrow"), the assembled output
    against the host oracle bit for bit."""
    import torch
    from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
    from stencilflow_tpu_torch.cardcheck import chunk_slabs, narrow_held
    from stencilflow_tpu_torch.dtypes import to_numpy
    t0 = time.perf_counter()
    for kind, p, plan in small:
        module, mode = (st, "local_narrow") if kind == "chunk" else \
            (tl, "narrow")
        module.launches_by[mode] = 0
        inputs = sft.load_input_arrays(p, seed=7)
        o = p.outputs[0]
        want_o = sft.run_interpreter(p, inputs)[o]
        full = np.zeros(p.dimensions, want_o.dtype)
        pieces = []
        if kind == "chunk":
            lib = lib_of[st.stream_source(plan)]
            for c in range(4):
                lo = c * plan.block - plan.halo_i
                slabs = chunk_slabs(p, inputs, lo, plan.extent())
                pieces.append((st.run_local_stream(plan, lo, slabs, lib),
                               st.local_stream_plain(plan, lo, slabs),
                               slice(c * plan.block, (c + 1) * plan.block)))
        else:
            arrays = spanned_arrays(p, inputs, device="cuda")
            pieces.append((tl.run_tile(plan, arrays,
                                       lib_of[tl.tile_source(plan)]),
                           tl.tile_plain(plan, arrays), slice(None)))
        torch.cuda.synchronize()
        n = module.launches_by[mode]
        worst = 0.0
        for got, want, at in pieces:
            g = to_numpy(got[o])
            ok, err = narrow_held(g, to_numpy(want[o]), 0.0)
            worst = max(worst, err)
            if not ok:
                raise RuntimeError(f"narrow {kind} kernel on {p.name} "
                                   "disagrees with its plain version")
            full[at] = g.reshape(full[at].shape)
        ok_o, err_o = narrow_held(full, want_o, 0.0)
        print(f"compare: narrow  {'K4' if kind == 'chunk' else 'K6'} "
              f"{kind:6s} {p.name:24s} tile {plan.tile}: max_abs_err "
              f"{worst:.3g} (oracle {err_o:.3g}) launches {n} "
              f"{'OK' if ok_o and n == len(pieces) else 'MISMATCH'} "
              "(bit-exact)", flush=True)
        if not ok_o or n != len(pieces):
            raise RuntimeError(f"narrow {kind} kernel on {p.name}: launches "
                               f"{n}, oracle max abs err {err_o}")
    print(f"narrow k4/k6: phase 3's cases took "
          f"{time.perf_counter() - t0:.1f} s | {smi}", flush=True)


def _nk_tiles(sft, tl, run_program, tiles, lib_of, smi, memo, twin):
    """Phase 4's K6 cells typed bf16 and f16: jacobi3d 512^3 x 2 through
    ``run --backend tile`` (fast mode, ``tile.AUTO_MODE``; 10 calls and
    the warm-up, so 11 narrow launches) and through
    ``compile_chain_tile(mode="masked")`` (one call), the narrow count
    set to 0 just before and read just after each; the kernel against
    its plain version on the same inputs and the entry point's output,
    bit for bit, timed beside 2 chained ``F.conv3d`` in the program's
    type (the bf16 inputs made from ``twin``'s, its float32 twin,
    ``_InputMemo.as_bf16``).  Returns the kernels line's entries."""
    import torch
    from stencilflow_tpu_torch.cardcheck import narrow_held
    from stencilflow_tpu_torch.dtypes import to_numpy, to_torch_dtype
    out = {}
    t0 = time.perf_counter()
    for (dt, mode), (p, plan) in tiles.items():
        o = p.outputs[0]
        if dt == "bfloat16":
            memo.as_bf16(p, twin)
        lib = lib_of[tl.tile_source(plan)]
        tl.launches_by["narrow"] = 0
        if mode == "fast":
            res = run_program(p, device="cuda", backend="tile",
                              repetitions=10, save_results=False,
                              log_level=0)
            main_out, main_ms, want_n = (res.outputs[o],
                                         res.wall_time_s * 1e3, 11)
            if res.backend != "tile":
                raise RuntimeError(f"{p.name}: backend {res.backend}")
            del res
        else:
            fn = tl.compile_chain_tile(p, mode="masked")
            t1 = time.perf_counter()
            main_out = to_numpy(fn(_spanned_on_card(sft, p))[o])
            main_ms, want_n = (time.perf_counter() - t1) * 1e3, 1
            # (one call, its inputs drawn and moved and its output read
            # back included)
        launches = tl.launches_by["narrow"]
        arrays = _spanned_on_card(sft, p)
        got = tl.run_tile(plan, arrays, lib)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = tl.tile_plain(plan, arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        g = to_numpy(got[o])
        ok, err = narrow_held(g, to_numpy(want[o]), 0.0)
        same = narrow_held(g, np.asarray(main_out).reshape(g.shape), 0.0)[0]
        del got, want, main_out
        ms = _time_ms(lambda: tl.run_tile(plan, arrays, lib), 10)
        del arrays
        torch.cuda.empty_cache()
        lib_ms = _conv_chain_ms(p, 1, dtype=to_torch_dtype(
            p.field_dtype(o)))
        torch.cuda.empty_cache()
        bound_ms, bound_by = _bound(p)
        key = f"tile_{'masked_' if mode == 'masked' else ''}typed_" \
              f"{_nk_tag(dt)}"
        print(f"kernel: {key} {p.name} {mode}, tile {plan.tile}, smem "
              f"{plan.smem_bytes()} B: {ms:.3f} ms "
              f"({p.total_elements / ms / 1e6:.2f} GCell/s) | entry point "
              f"{main_ms:.3f} ms, launches {launches} (expected {want_n}), "
              f"{'equal to the kernel' if same else 'DIFFERS'} | plain "
              f"version {plain_ms:.1f} ms, max_abs_err {err:.3g} "
              f"{'bit-equal' if ok else 'MISMATCH'} | bound {bound_ms:.4f} "
              f"ms ({bound_by}, 2 B a cell) | {len(p.kernels)} chained "
              f"F.conv3d in {_nk_tag(dt)} {lib_ms:.3f} ms | {smi}",
              flush=True)
        if not ok or not same or launches != want_n:
            raise RuntimeError(f"{key}: K6 disagrees with its plain version "
                               "or its entry point")
        out[key] = {"name": key, "route": "cuda",
                    "source": "stencilflow_tpu_torch/backend/codegen.py",
                    "replaces": K6_REPLACES, "launches": launches,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms}
    print(f"narrow k4/k6: phase 4's K6 cells took "
          f"{time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    return out


def _nk_outofcore(sft, st, pn, ov, gp, tl, oc, lib_of, smi, run_program,
                  memo, twin):
    """Phase 5's narrow cell: ``run --host-chunks 8`` on jacobi3d 1024^3 x
    8 typed bf16.  K4 alone on the middle chunk against its plain version
    (bit for bit) and timed; then the in-core narrow route (K1) and the
    out-of-core call on the same inputs, the counts set to 0 just before
    and read just after the latter (K4's narrow launches: 8 a call,
    nothing else launched), bit-equal to the in-core route; its ms a
    call, the bytes over the host link and the link's bound.  The inputs
    are ``twin``'s (the float32 cell) rounded to bf16
    (``_InputMemo.as_bf16``).  Returns K4's entry of the kernels line."""
    import torch
    from stencilflow_tpu_torch import outofcore
    from stencilflow_tpu_torch.cardcheck import chunk_slabs, narrow_held
    from stencilflow_tpu_torch.dtypes import to_numpy
    from stencilflow_tpu_torch.report import Report
    t0 = time.perf_counter()
    p, chunks, plan = oc
    memo.as_bf16(p, twin)
    o = p.outputs[0]
    lib = lib_of[st.stream_source(plan)]
    _, J, K = p.dimensions
    c = chunks // 2
    lo = c * plan.block - plan.halo_i
    slabs = chunk_slabs(p, sft.load_input_arrays(p, seed=0), lo,
                         plan.extent())
    got = st.run_local_stream(plan, lo, slabs, lib)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = st.local_stream_plain(plan, lo, slabs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    ok, err = narrow_held(to_numpy(got[o]), to_numpy(want[o]), 0.0)
    del got, want
    ms = _time_ms(lambda: st.run_local_stream(plan, lo, slabs, lib), 10)
    in_bytes = sum(t.numel() * t.element_size() for n, t in slabs.items()
                   if not p.inputs[n].is_scalar)
    out_bytes = plan.block * J * K * 2
    bound_ms, bound_by = _share_bound(p, in_bytes, out_bytes,
                                      plan.block / p.dimensions[0])
    del slabs
    torch.cuda.empty_cache()
    lib_ms = _conv_chain_ms(p, 1, shape=(plan.extent(), J, K),
                            dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    if not ok:
        raise RuntimeError(f"K4 on {p.name} disagrees with its plain "
                           "version")
    reps = 2
    res = run_program(p, device="cuda", repetitions=reps,
                      save_results=False, log_level=0)
    in_core, route, in_ms = res.outputs[o], res.backend, \
        res.wall_time_s * 1e3
    del res
    torch.cuda.empty_cache()
    up_rate, down_rate = _link_rates()
    _counts_zero(pn, ov, gp, tl, st)
    res = run_program(p, device="cuda", host_chunks=chunks,
                      repetitions=reps, save_results=False, log_level=0)
    counts = _counts(pn, ov, gp, tl, st)
    n = counts.pop("stream:local_narrow", 0)
    label = f"outofcore[stream x{chunks} chunks]"
    if res.backend != label or n != chunks * (reps + 1) or counts:
        raise RuntimeError(f"{p.name}: {res.backend} launched K4 {n} times "
                           f"over {reps + 1} calls (others {counts})")
    same = narrow_held(res.outputs[o], in_core, 0.0)[0]
    up, down = outofcore.link_bytes(p, outofcore.ChunkPlan(
        chunks, plan.block, plan.halo_i, "stream", {}))
    duplex = max(up / up_rate, down / down_rate) * 1e3
    io = Report.build(p).hbm_footprint_bytes()
    print(f"outofcore: {p.name} --host-chunks {chunks}: {res.backend} "
          f"{res.wall_time_s * 1e3:.3f} ms a call (CUDA events over {reps} "
          f"calls, transfers included) | in-core {route} {in_ms:.3f} ms | "
          f"{'equal to' if same else 'DIFFERS FROM'} the in-core route | K4 "
          f"narrow launches {n} over {reps + 1} calls ({chunks} a call) | "
          f"link {up / 2 ** 30:.3f} GiB up + {down / 2 ** 30:.3f} GiB "
          f"down, bound {duplex:.3f} ms both ways at once (link "
          f"{up_rate / 1e9:.2f} / {down_rate / 1e9:.2f} GB/s) | in-core "
          f"in+out {io / 2 ** 30:.3f} GiB | K4 on chunk {c} of {chunks} "
          f"tile {plan.tile} x {plan.threads}, {_loads(plan)}: {ms:.3f} ms, "
          f"plain version "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{len(p.kernels)} chained F.conv3d in bf16 over the widened "
          f"chunk {lib_ms:.3f} ms, max_abs_err {err:.3g} | leg "
          f"{time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    if not same:
        raise RuntimeError(f"{p.name}: the narrow out-of-core call differs "
                           "from the in-core route")
    del res, in_core
    torch.cuda.empty_cache()
    return {"name": "local_stream_typed_bf16", "route": "cuda",
            "source": "stencilflow_tpu_torch/backend/codegen.py",
            "replaces": K4_REPLACES, "launches": n, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def _nk_solvers(sft, pn, ov, gp, tl, st, solvers, smi):
    """Phase 7's narrow legs: ``iterate`` on jacobi3d 512^3 typed bf16
    fused by 8, 32 steps, checkpointed at step 16 by a first call and
    resumed by a second, bit-equal to the uninterrupted run;
    ``fast_value_and_grad`` on jacobi3d 256^3 x 8 bf16, its gradient
    bit-equal to the adjoint program's dense lowering on the card; CG on
    backward Euler 512^3 typed f16 cut to its first 4 iterations.  Each
    with the counts set to 0 just before and read just after."""
    import tempfile
    import torch
    from stencilflow_tpu_torch.backend.dense import compile_chain
    from stencilflow_tpu_torch.dtypes import BFLOAT16, to_numpy, to_torch
    from stencilflow_tpu_torch.grad import _adjoint_extras
    t0 = time.perf_counter()
    step, grad, euler = solvers
    inputs = sft.load_input_arrays(step, seed=0)
    with tempfile.TemporaryDirectory() as d:
        _counts_zero(pn, ov, gp, tl, st)
        sft.iterate(step, inputs, 16, fuse=8, checkpoint_every=16,
                    checkpoint_dir=d)
        with np.load(os.path.join(d, "step_16.npz")) as z:
            kept = z["a"].dtype
        stats = {}
        resumed = sft.iterate(step, inputs, 32, fuse=8, checkpoint_every=16,
                              checkpoint_dir=d, stats=stats)
        counts = _counts(pn, ov, gp, tl, st)
    whole = sft.iterate(step, inputs, 32, fuse=8, device="cuda")
    same = all(resumed[k].dtype == whole[k].dtype and np.array_equal(
        resumed[k].view(np.uint8), whole[k].view(np.uint8)) for k in whole)
    del inputs, resumed, whole
    t_it = time.perf_counter() - t0
    print(f"solvers: iterate {step.name} 32 steps fused by 8, checkpointed "
          f"at 16 ({kept}) and resumed: {stats['backend']}, launches "
          f"{counts}, {'bit-equal to' if same else 'DIFFERS FROM'} the "
          f"uninterrupted run | {t_it:.1f} s | {smi}", flush=True)
    if kept != BFLOAT16 or not same or not counts:
        raise RuntimeError("narrow iterate: the resumed run differs")
    t1 = time.perf_counter()
    ginputs = sft.load_input_arrays(grad, seed=0)
    f = sft.fast_value_and_grad(grad, device="cuda")
    f(ginputs)
    torch.cuda.synchronize()
    _counts_zero(pn, ov, gp, tl, st)
    value, grads = f(ginputs)
    torch.cuda.synchronize()
    counts = _counts(pn, ov, gp, tl, st)
    adj, cot = sft.adjoint_program(grad)
    o = grad.outputs[0]
    dense = compile_chain(adj)({cot[o]: torch.ones(
        grad.raw_dimensions, dtype=torch.bfloat16, device="cuda"), **{
        k: to_torch(v, "cuda") for k, v in _adjoint_extras(adj, cot).items()}})
    name = next(iter(grads))
    g = to_numpy(grads[name])
    ok = g.dtype == BFLOAT16 and np.array_equal(
        g.view(np.uint16),
        to_numpy(dense[f"adj_{name}"]).reshape(g.shape).view(np.uint16))
    del dense, grads, ginputs
    torch.cuda.empty_cache()
    print(f"solvers: fast_value_and_grad {grad.name} ({f.lowering}) value "
          f"{float(value):.6g}, launches {counts}, gradient "
          f"{'bit-equal to' if ok else 'DIFFERS FROM'} the adjoint's dense "
          f"lowering | {time.perf_counter() - t1:.1f} s | {smi}", flush=True)
    if not ok or len(counts) < 1:
        raise RuntimeError("narrow fast_value_and_grad: the gradient differs")
    t1 = time.perf_counter()
    solver = sft.make_solver(euler, maxiter=4, device="cuda")
    # the dots stay in float16, as the JAX package's do: a right-hand side
    # in [0, 0.02) keeps |b|^2 over 512^3 cells below float16's largest
    # value (one in [0, 1) overflows it, and CG stops at once)
    rhs = (torch.rand(euler.dimensions, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0))
           * 0.02).half()
    _counts_zero(pn, ov, gp, tl, st)
    x, info = solver(rhs)
    torch.cuda.synchronize()
    counts = _counts(pn, ov, gp, tl, st)
    good = (info["iterations"] == 4 and x.dtype == torch.float16
            and bool(torch.isfinite(x).all()) and info["residual"] < 1)
    print(f"solvers: solve_cg {euler.name} ({solver.lowering}) 4 "
          f"iterations in float16: residual {info['residual']:.4g}, "
          f"launches {counts} | {time.perf_counter() - t1:.1f} s | {smi}",
          flush=True)
    if not good or not counts:
        raise RuntimeError(f"narrow solve_cg: {info}")
    print(f"solvers: the narrow legs took {time.perf_counter() - t0:.1f} s "
          f"| {smi}", flush=True)


def _nk_sharded(sft, st, pn, ov, gp, tl, dist, smi, memo, twin):
    """Phase 9's narrow cell: jacobi3d 512^3 x 8 typed bf16 over 2 x 2
    (domain) and over 4 positions (pipeline), each driven once with the
    counts set to 0 just before and read just after (K4's narrow
    launches: the shards, or segments x chunks; nothing else), bit-equal
    to the single-device narrow route; then the last shard and segment 0
    on chunk 1 through K4 against its plain version (bit for bit) and
    timed, beside chained ``F.conv3d`` in bf16 over its widened block.
    The inputs are ``twin``'s (phase 9's float32 cell) rounded to bf16
    (``_InputMemo.as_bf16``).  Returns the two entries of the kernels
    line."""
    import torch
    from stencilflow_tpu_torch.backend import compile_chain_best
    from stencilflow_tpu_torch.cardcheck import narrow_held
    from stencilflow_tpu_torch.dtypes import to_numpy, to_torch
    from stencilflow_tpu_torch.parallel import (compile_pipeline_split,
                                                compile_sharded_chain)
    from stencilflow_tpu_torch.parallel.domain import place_global_inputs
    p, jk, p4 = dist
    o = p.outputs[0]
    memo.as_bf16(p, twin)
    inputs = sft.load_input_arrays(p, seed=0)
    dev_in = {n: to_torch(v, "cuda") if np.ndim(v) else v
              for n, v in inputs.items()}
    single, route = compile_chain_best(p, device="cuda")
    ref = to_numpy(single(dev_in)[o]).reshape(p.raw_dimensions)
    entries = {}
    for key, segment in (("local_stream_shard_typed_bf16", False),
                         ("local_stream_segment_typed_bf16", True)):
        t0 = time.perf_counter()
        if segment:
            fn, plan = compile_pipeline_split(p, p4, "p")
            placed, sp, mode = fn.place(dev_in), fn.stream_plans[0], \
                "stream:local_narrow"
            want_n = len(plan.segments) * plan.num_chunks
        else:
            fn, plan = compile_sharded_chain(p, jk, (None, "x", "y"))
            placed, sp, mode = place_global_inputs(p, plan, inputs), \
                fn.plan, "stream:shard_narrow"
            want_n = jk.size
        if fn.last_config["backend"] != "stream":
            raise RuntimeError(f"narrow {key}: {fn.last_config}")
        torch.cuda.synchronize()
        _counts_zero(pn, ov, gp, tl, st)
        out = fn(placed)
        torch.cuda.synchronize()
        counts = _counts(pn, ov, gp, tl, st)
        n = counts.pop(mode, 0)
        got_all = to_numpy(out[o].gather(torch.device("cuda", 0)))
        same = narrow_held(got_all, ref, 0.0)[0]
        del out, got_all
        ms = _time_ms(lambda: fn(placed), 5)
        if segment:
            E = plan.widen[0][0]
            lo = plan.chunk - E
            tiles = {n_: _i_window(v, lo, plan.chunk + 2 * E)
                     if not p.inputs[n_].is_scalar
                     and p.inputs[n_].dim_mask[0] else v
                     for n_, v in dev_in.items() if n_ in sp.program.inputs}
            args, extra, where = (lo, tiles), (), "segment 0, chunk 1"
        else:
            per = fn.exchange(placed)
            c = list(per)[-1]
            oi, oj, ok = plan.block_origin(c)
            tiles = per[c]
            args, extra = (oi - plan.halo[0], tiles), (oj, ok,
                                                       plan.instance(c))
            where = f"shard {c}"
        lib = st.build_stream(sp)   # built in phase 2: a lookup
        got = st.run_local_stream(sp, *args, lib, *extra)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = st.local_stream_plain(sp, *args, *extra)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        so = sp.program.outputs[0]
        if segment:   # the in-domain planes of the segment's block
            g0 = args[0] + sp.halo_i
            win = slice(max(0, -g0), min(sp.block, p.dimensions[0] - g0))
        else:
            win = slice(None)
        good, err = narrow_held(to_numpy(got[so][win]),
                                 to_numpy(want[so][win]), 0.0)
        out_bytes = sum(t.numel() * t.element_size() for t in got.values())
        del got, want
        k_ms = _time_ms(lambda: st.run_local_stream(sp, *args, lib, *extra),
                        5)
        in_bytes = sum(t.numel() * t.element_size() for n_, t in tiles.items()
                       if n_ in sp.program.inputs
                       and not sp.program.inputs[n_].is_scalar)
        bound_ms, bound_by = _share_bound(
            sp.program if segment else p, in_bytes, out_bytes,
            sp.block / p.dimensions[0] if segment else 1 / jk.size)
        wide = tuple(next(t.shape for n_, t in tiles.items()
                          if n_ in sp.program.inputs
                          and not sp.program.inputs[n_].is_scalar))
        lib_ms = _conv_chain_ms(sp.program, 1, shape=wide,
                                dtype=torch.bfloat16)
        print(f"narrow k4/k6: {p.name} "
              f"{'over 4 positions (pipeline)' if segment else 'over 2 x 2 (domain)'}"
              f" {ms:.3f} ms a call, K4 narrow launches {n} (expected "
              f"{want_n}, others {counts}), "
              f"{'bit-equal to' if same else 'DIFFERS FROM'} the "
              f"single-device {route} | {where}: tile {sp.tile} x "
              f"{sp.threads}, smem {sp.smem_bytes()} B, {_loads(sp)}, "
              f"{k_ms:.3f} ms, plain "
              f"version {plain_ms:.1f} ms, max_abs_err {err:.3g} "
              f"{'OK' if good else 'MISMATCH'}, bound {bound_ms:.4f} ms "
              f"({bound_by}), {len(sp.program.kernels)} chained F.conv3d in "
              f"bf16 over {wide} {lib_ms:.3f} ms | leg "
              f"{time.perf_counter() - t0:.1f} s | {smi}", flush=True)
        if not same or not good or n != want_n or counts:
            raise RuntimeError(f"narrow {key}: differs, or launches {n} "
                               f"(others {counts})")
        entries[key] = {"name": key, "route": "cuda",
                        "source": "stencilflow_tpu_torch/backend/codegen.py",
                        "replaces": K4_REPLACES, "launches": n,
                        "max_abs_err": err, "ms": k_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": lib_ms}
        del placed, tiles
        torch.cuda.empty_cache()
    return entries


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("error: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "stencilflow_tpu_torch")):
        print("error: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)

    import stencilflow_tpu_torch as sft
    from stencilflow_tpu_torch.backend import (build, codegen,
                                               compile_chain_rows)
    from stencilflow_tpu_torch.backend import group as gp
    from stencilflow_tpu_torch.backend import overlap as ov
    from stencilflow_tpu_torch.backend import panel as pn
    from stencilflow_tpu_torch.backend import stream as st
    from stencilflow_tpu_torch.backend import tile as tl
    from stencilflow_tpu_torch.backend.stacked_io import spanned_arrays
    from stencilflow_tpu_torch.config import MXU_VERIFY_RTOL, VERIFY_RTOL
    from stencilflow_tpu_torch.driver import run_program
    from stencilflow_tpu_torch.backend.dense import chain_halo
    from stencilflow_tpu_torch.cardcheck import (chunk_slabs, fuzz_programs,
                                                 local_plan, wide_i_spec)
    from stencilflow_tpu_torch.frontend.canonicalize import \
        rotate_2d_to_rows as rows
    from stencilflow_tpu_torch.synthesize import synthesize_stencil

    # -- 1. device -----------------------------------------------------------
    t_run = time.perf_counter()
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi} | torch: {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # -- programs of phases 3 and 4 -----------------------------------------
    def synth(shape, n, iters, extent=1, **kw):
        return sft.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=(n, n, n) if isinstance(n, int)
            else n, shape=shape, extent=extent,
            seed_data="random:0.0,1.0", **kw),
            name=f"{shape}3d_{n if isinstance(n, int) else n[0]}_"
                 f"{iters}itr")

    # the random chains: the 3-D float32 one (drawn again for K4), and the
    # float64 one with shrink BCs and the int32 one, scalar and lower-rank
    # inputs through K1, K2 and K6 (the example programs and the other
    # chains run in tests/test_torch_cuda.py)
    cases = fuzz_programs(("fuzz-f32", "fuzz-f64-shrink", "fuzz-i32"))
    small = (40, 48, 72)
    stream_cases = [
        ("box-r1", synth("box", small, 4, 1)),
        ("box-r2", synth("box", small, 4, 2)),
        ("box-r2-bc0.7", synth("box", small, 3, 2, boundary_value=0.7)),
        ("box-r1-shrink", synth("box", small, 3, 1, boundary="shrink")),
        ("cross-r2", synth("cross", small, 4, 2)),
        ("mixed", sft.parse_program(_mixed_spec(small), name="mixed")),
    ]
    jacobi8 = sft.parse_program(synthesize_stencil(
        num_stages=8, dimensions=(512,) * 3, shape="diffusion",
        seed_data="random:0.0,1.0"), name="jacobi3d_512_8itr")
    jacobi2 = sft.parse_program(synthesize_stencil(
        num_stages=2, dimensions=(512,) * 3, shape="diffusion",
        seed_data="random:0.0,1.0"), name="jacobi3d_512_2itr")
    box256 = synth("box", 256, 8, 2)
    cross256 = synth("cross", 256, 8, 2)
    hdiff8 = synth("hdiff", 256, 8)
    hotspot8 = synth("hotspot", 256, 8)
    mains = [(jacobi8, "panel"), (jacobi2, "overlap"), (hdiff8, "panel"),
             (hotspot8, "panel"),
             (box256, "stream"), (cross256, "stream")]

    def synth2d(shape, n, iters, **kw):
        return sft.parse_program(synthesize_stencil(
            num_stages=iters, dimensions=n, shape=shape,
            seed_data="random:0.0,1.0", **kw),
            name=f"{shape}2d_{n[0]}_{iters}itr"
                 f"{'_' + kw['boundary'] if 'boundary' in kw else ''}")

    # jacobi2d 256 x 192 x 8 through rows (the bf16 rings' K5 leg)
    jacobi2d_rows = rows(synth2d("diffusion", (256, 192), 8,
                                 boundary="constant"))
    # the group kernel (phase 3): (label, program the kernel runs, B, g);
    # the other BCs, hotspot2d, the fuzz chains and i-segments run in
    # tests/test_torch_cuda.py
    group_cases = [
        ("jacobi2d-shrink", rows(synth2d("diffusion", (256, 192), 8,
                                         boundary="shrink")), 64, 8),
        ("jacobi3d-i3", sft.parse_program(wide_i_spec((24, 40, 72), 4),
                                          name="jacobi3d_i3"), 2, 2)]
    # K4, the local chunk kernel (phase 3): (label, program, chunks)
    local_cases = [(f"jacobi3d-64-{bc}", sft.parse_program(
        synthesize_stencil(num_stages=3, dimensions=(64,) * 3,
                           shape="diffusion", boundary=bc,
                           seed_data="random:0.0,1.0"),
        name=f"jacobi3d_64_3itr_{bc}"), 4)
        for bc in ("constant", "copy", "shrink")]
    local_cases += [
        ("hdiff-dag", sft.parse_program(synthesize_stencil(
            num_stages=2, dimensions=(8, 12, 16), shape="hdiff"),
            name="hdiff_dag"), 4),
        ("box-r2-banded", synth("box", small, 2, 2), 2),
        _fuzz_chunked(cases)]
    # the out-of-core cells (phase 5): (program, chunks)
    jacobi1024 = sft.parse_program(synthesize_stencil(
        num_stages=8, dimensions=(1024,) * 3, shape="diffusion",
        seed_data="random:0.0,1.0"), name="jacobi3d_1024_8itr")
    oc_cells = [(jacobi1024, 8), (synth("hotspot", 512, 8), 4)]
    # phase 5's chunk leg of K4's bf16 passes: box3d 512^3 x 8, extent 2
    box512 = synth("box", 512, 8, 2)
    jacobi2d = synth2d("diffusion", (8192, 8192), 8)
    hotspot2d = synth2d("hotspot", (8192, 8192), 8)
    hdiff2d = synth2d("hdiff", (8192, 8192), 16)
    mains2d = [(jacobi2d, "rows+group_g8"), (hotspot2d, "rows+group_g8"),
               (hdiff2d, "panel")]
    mains += mains2d
    # the reconvergent 16-stage chain (the bf16 rings' K3c leg)
    reconvergent = sft.parse_program(_reconvergent_spec(),
                                     name="reconvergent_16")
    # the deep 3-D cells (phase 4): the stream kernel's spill rung
    jacobi32 = synth("diffusion", 512, 32)
    # hotspot3d cut from 32 stages to 24 (21 of 25 rings still spilled) to
    # keep the script's time
    deep = [jacobi32, synth("hdiff", 256, 16), synth("hotspot", 256, 24)]
    deep_names = {p.name for p in deep}

    # -- 2. build: every kernel, one nvcc each, all at once ------------------
    t0 = time.perf_counter()
    # name: (module, plan, build, wrapper, plain version)
    kernels = {"panel": (pn, pn.PanelPlan, pn.build_panel, pn.run_panel,
                         pn.panel_plain),
               "overlap": (ov, ov.OverlapPlan, ov.build_overlap,
                           ov.run_overlap, ov.overlap_plain)}
    sources = []
    plain_cases = []
    for label, p in cases[1:]:
        an = sft.ChainAnalysis.run(p)
        for kname, (_, plan_cls, _, _, _) in kernels.items():
            plan = plan_cls.build(an)
            plain_cases.append((label, kname, p, an, plan))
            src = (codegen.panel_source if kname == "panel" else
                   codegen.overlap_source)(p, an, plan)
            sources.append((src, kname))
    # K2 alone: hotspot3d (two streamed inputs, scalars) on the rule's
    # plan, with runs of 4 j cells and as the skeleton alone, and a 2-D
    # chain of 2 stages (I = 1)
    for label, p, kw in (
            ("hotspot3d-2", synth("hotspot", (24, 40, 72), 2), {}),
            ("hotspot3d-2-R4", synth("hotspot", (24, 40, 72), 2),
             dict(tile=(4, 8, 32), R=4, window=True)),
            ("hotspot3d-2-skeleton", synth("hotspot", (24, 40, 72), 2),
             dict(tile=(4, 8, 32), R=1, window=False)),
            ("jacobi2d-2", sft.parse_program(synthesize_stencil(
                num_stages=2, dimensions=(96, 200), shape="diffusion",
                seed_data="random:0.0,1.0"), name="jacobi2d_96_2itr"), {})):
        an = sft.ChainAnalysis.run(p)
        plan = ov.OverlapPlan.build(an, **kw)
        plain_cases.append((label, "overlap", p, an, plan))
        sources.append((codegen.overlap_source(p, an, plan), "overlap"))
    stream_plans = []
    for label, p in stream_cases + [("box3d_256_8itr", box256),
                                    ("cross3d_256_8itr", cross256)]:
        plan = st.plan_stream(p)
        stream_plans.append((label, p, plan))
        sources.append((st.stream_source(plan), "stream"))
    # the band passes on their other route (tensor cores against CUDA
    # cores): phase 3's banded cases, and box and cross 256^3 x 8, timed
    # in turns with their routes' plans in phase 4
    other_route = {}
    for label, p, plan in stream_plans:
        if plan.tkeys:
            other = "fma" if "mma" in _routes(plan) else "mma"
            other_route[label] = (p, st.plan_stream(p, passes=other))
            sources.append((st.stream_source(other_route[label][1]),
                            "stream"))
    main_panel = {}
    for p, _ in mains[:4]:
        an = sft.ChainAnalysis.run(p)
        plan = (ov.OverlapPlan if p is jacobi2 else pn.PanelPlan).build(an)
        sources.append(((codegen.overlap_source if p is jacobi2 else
                         codegen.panel_source)(p, an, plan),
                        "overlap" if p is jacobi2 else "panel"))
    for p in (box256, cross256):   # forced panel, where its planner fits
        an = sft.ChainAnalysis.run(p)
        try:
            plan = pn.PanelPlan.build(an)
        except ValueError as exc:
            main_panel[p.name] = str(exc)
            continue
        main_panel[p.name] = (an, plan)
        sources.append((codegen.panel_source(p, an, plan), "panel"))
    # the group kernel: phase 3's cases, then the 2-D main path's plans
    group_plans = []
    for label, p, B, g in group_cases + [
            (q.name, rows(q), 64, 8) for q, want in mains2d
            if want == "rows+group_g8"]:
        an = sft.ChainAnalysis.run(p)
        plan = gp.plan_group(p, an, B, g)
        src = codegen.group_source(p, an, plan)
        group_plans.append((label, p, an, plan, src))
        sources.append((src, "group"))
    # beside the 2-D cells: forced overlap on the unrotated plane (the
    # route before the rows path), forced rows+panel; a panel route's
    # kernel, and beside it the stream kernel's packed plan (its route
    # before the panel kernel packed its rings)
    forced2d, stream2d = {}, {}
    for p, want in mains2d:
        an = sft.ChainAnalysis.run(p)
        if want == "panel":
            sources.append((codegen.panel_source(p, an, pn.PanelPlan.build(
                an)), "panel"))
            stream2d[p.name] = st.plan_stream(p, an, mxu="off")
            sources.append((st.stream_source(stream2d[p.name]), "stream"))
        try:
            oplan = ov.OverlapPlan.build(an)
            sources.append((codegen.overlap_source(p, an, oplan), "overlap"))
        except ValueError as exc:
            oplan = str(exc)
        rot = rows(p)
        ran = sft.ChainAnalysis.run(rot)
        pplan = pn.PanelPlan.build(ran)
        sources.append((codegen.panel_source(rot, ran, pplan), "panel"))
        forced2d[p.name] = (an, oplan, pplan)
    # K4: phase 3's chunk plans, then the out-of-core cells' chunk plans
    # and their in-core (panel) plans
    local_plans = []
    for label, p, chunks in local_cases:
        plan = local_plan(p, chunks)
        local_plans.append((label, p, chunks, plan))
        sources.append((st.stream_source(plan), "local_stream"))
    oc_plans = {}
    for p, chunks in oc_cells:
        oc_plans[p.name] = local_plan(p, chunks)
        sources.append((st.stream_source(oc_plans[p.name]), "local_stream"))
        an = sft.ChainAnalysis.run(p)
        sources.append((codegen.panel_source(p, an, pn.PanelPlan.build(an)),
                        "panel"))
    # K4's bf16 passes at 4 chunks and the split chunk plan beside them,
    # and the in-core f32 route of the same program
    oc_bf16 = (local_plan(box512, 4, "bf16"), local_plan(box512, 4))
    sources += [(st.stream_source(q), "local_stream") for q in oc_bf16]
    sources.append((st.stream_source(st.plan_stream(box512)), "stream"))
    # K3c: jacobi3d 64^3 x 3 with shrink BCs, every ring spilled (phase 3;
    # the other small cases run in tests/test_torch_cuda.py), K4 spilled
    # at 4 chunks, the deep cells' route plans (rung 4: every stage per
    # cell, spilled)
    spill_small = st.plan_stream(local_cases[2][1], spill="all")
    sources.append((st.stream_source(spill_small), "stream"))
    lp = local_cases[1][1]   # jacobi3d 64^3 x 3, copy BCs
    lan = sft.ChainAnalysis.run(lp)
    local_spill = st.plan_local(lp, lan, lp.dimensions[0] // 4,
                                chain_halo(lan)[0], spill="all")
    sources.append((st.stream_source(local_spill), "local_stream"))
    deep_plans = {}
    for p in deep:
        deep_plans[p.name] = st.plan_stream(p, mxu="off")
        sources.append((st.stream_source(deep_plans[p.name]), "stream"))
    # the reduced-precision modes (bf16 rings: K1, K5, K3a, K3c; single-pass
    # bf16 band passes: K3b): phase 3's small cases, then phase 4's
    # full-width plans, which the run_program legs rebuild as lookups
    bf16_small, bf16_main = [], {}
    for label, kernel, p, kw in (
            ("K1 jacobi3d", "panel", synth("diffusion", small, 4), {}),
            ("K5 jacobi2d rows", "group", jacobi2d_rows, {}),
            ("K3a jacobi3d", "stream", synth("diffusion", small, 4),
             {"mxu": "off"}),
            ("K3c reconvergent", "stream", reconvergent,
             {"smem_budget": 40000}),
            ("K3b box-r2", "stream", stream_cases[1][1],
             {"mxu_precision": "bf16"}),
            ("K3b box-r2 mma", "stream", stream_cases[1][1],
             {"mxu_precision": "bf16", "passes": "mma"}),
            ("K3b cross-r2", "stream", stream_cases[4][1],
             {"mxu_precision": "bf16"})):
        bf16_small.append((label, kernel, p) + _bf16_plan(
            sft, pn, gp, st, codegen, kernel, p, kw))
        sources.append((bf16_small[-1][-1], kernel))
    for key, kernel, p, kw in (
            ("panel_bf16", "panel", jacobi8, {}),
            ("stream_spill_bf16", "stream", jacobi32, {"mxu": "off"}),
            ("group_bf16", "group", rows(jacobi2d), {}),
            ("stream_bf16", "stream", box256, {"mxu_precision": "bf16"})):
        bf16_main[key] = (kernel, p) + _bf16_plan(sft, pn, gp, st, codegen,
                                                  kernel, p, kw)
        sources.append((bf16_main[key][-1], kernel))
    # bf16 and f16 compute (compute_dtype: K3a, K3b, K3c): phase 3's
    # small cases, then phase 4's legs, each beside the f32 stream plan on
    # its tile (where that fits)
    cbf_small = []
    for label, p, kw, cd in (
            ("K3a jacobi3d", synth("diffusion", small, 4), {"mxu": "off"},
             "bfloat16"),
            ("K3a hotspot3d", synth("hotspot", small, 3,
                                    boundary_value=0.3), {}, "bfloat16"),
            ("K3b box-r2", stream_cases[2][1], {}, "bfloat16"),
            ("K3b box-r2 fma", stream_cases[2][1], {"passes": "fma"},
             "bfloat16"),
            ("K3c jacobi3d spilled", local_cases[0][1], {"spill": "all"},
             "bfloat16"),
            ("K3a hotspot3d f16", synth("hotspot", small, 3,
                                        boundary_value=0.3), {}, "float16"),
            ("K3b box-r2 f16", stream_cases[2][1], {}, "float16"),
            ("K3c jacobi3d spilled f16", local_cases[0][1],
             {"spill": "all"}, "float16")):
        plan = st.plan_stream(p, compute_dtype=cd, **kw)
        cbf_small.append((label, p, plan))
        sources.append((st.stream_source(plan), "stream"))
    cbf_main = {}
    for key, p, cd in (("stream_compute_bf16", jacobi8, "bfloat16"),
                       ("stream_compute_bf16_banded", box256, "bfloat16"),
                       ("stream_compute_f16", jacobi8, "float16")):
        plan = st.plan_stream(p, compute_dtype=cd)
        try:
            f32 = st.plan_stream(p, tile=plan.tile)
        except ValueError:
            f32 = st.plan_stream(p)
        cbf_main[key] = (p, plan, f32)
        sources += [(st.stream_source(q), "stream") for q in (plan, f32)]
    # compute types of programs typed other than float32, int32 and bool
    # compute: phase 3's small cases (K3a, K3c), then phase 4's cells
    ct_small, ct_mains, ct_sources = _ct_setup(sft, st, synthesize_stencil)
    sources += ct_sources
    # programs typed bfloat16 and float16: phase 3's small cases of K1, K2,
    # K3a, K3c and K5, then phase 4's full-width rows
    narrow_cases, narrow_mains, narrow_sources = _narrow_setup(
        sft, pn, ov, gp, st, codegen, rows, synthesize_stencil, small)
    sources += narrow_sources
    # programs typed bfloat16 and float16 on K4 and K6 and the entry points
    # above them: phase 3's small cases, then phases 4, 5, 7 and 9's cells
    nk_setup, nk_sources, nk_thunks = _nk_setup(sft, st, tl,
                                                synthesize_stencil)
    sources += nk_sources
    # K6: phase 3's random chains in both modes, then the forced cells of
    # phase 4
    tile_plans = []
    for label, p in cases[1:]:
        for mode in ("masked", "fast"):
            plan = tl.plan_tile(p, mode=mode)
            tile_plans.append((label, p, plan))
            sources.append((tl.tile_source(plan), "tile"))
    tile_main = {}
    for p, mode in ((jacobi2, "masked"), (jacobi2, "fast"),
                    (hdiff8, tl.AUTO_MODE)):
        tile_main[p.name, mode] = tl.plan_tile(p, mode=mode)
        sources.append((tl.tile_source(tile_main[p.name, mode]), "tile"))
    # the probes of phase 6, built from csrc/probes/ (the names and text
    # probes.load builds them with, so phase 6 finds them built)
    from stencilflow_tpu_torch import probes
    from stencilflow_tpu_torch.probes import stateless_panel as sp
    sources += [(probes.source(n), f"probe_{n}") for n in (
        "copy", "alu", "dma_overlap", "table_read", "stateless_panel")]
    # K2 on P5's program at its main shape (phase 6)
    p5 = sp.program(sp.MAIN)
    an5 = sft.ChainAnalysis.run(p5)
    sources.append((codegen.overlap_source(p5, an5, ov.OverlapPlan.build(
        an5)), "overlap"))
    # the solvers phase's lowerings (composed and adjoint programs among
    # them) compile on threads beside, each through its entry point
    solver_progs, solver_thunks = _solver_setup(sft, jacobi8)
    # phase 9's sharded engines and single-device routes, the same way
    sharded_setup, sharded_thunks = _sharded_setup(sft, jacobi8, box256)
    # phase 4's autotune leg: every default candidate of cross3d 256^3 x 8
    autotune_build_s = {}
    autotune_thunks = _autotune_thunks(cross256, autotune_build_s)
    with ThreadPoolExecutor(max_workers=8) as pool:
        solver_built = [pool.submit(t) for t in solver_thunks
                        + sharded_thunks + autotune_thunks + nk_thunks]
        libs = build.load_libraries(sources)
        for fut in solver_built:
            fut.result()
    lib_of = {src: lib for (src, _), lib in zip(sources, libs)}
    slow = max(build.build_log, key=lambda x: x[1]) if build.build_log \
        else ("-", 0.0)
    print(f"build: {len(build.build_log)} programs, one nvcc each in "
          f"parallel, in {time.perf_counter() - t0:.1f}s (slowest "
          f"{slow[0]} {slow[1]:.1f}s)", flush=True)

    # each program's inputs drawn once a phase (the oracles' threads draw
    # phase 4's first, and its calls take them from the memo)
    inputs_memo = _InputMemo(sft)
    inputs_memo.on = True
    # the numpy oracles of phase 4's cells, computed on host threads while
    # the card works through phases 3 and 4 (the same inputs as
    # run_program's: seed 0)
    oracle_pool = ThreadPoolExecutor(max_workers=3)
    oracle_of = {p.name: oracle_pool.submit(
        lambda p=p: sft.run_interpreter(p, sft.load_input_arrays(p, seed=0)))
        for p in [q for q, _w in mains] + deep
        if max(p.dimensions) <= 256 or p is jacobi2d or p is hotspot2d}

    # -- 3. kernel vs plain on the card --------------------------------------
    print(f"phase: 3 at {time.perf_counter() - t_run:.1f} s", flush=True)
    for (label, kname, p, an, plan), (src, _) in zip(plain_cases, sources):
        module, _, _, run, plain = kernels[kname]
        lib = lib_of[src]
        inputs = sft.load_input_arrays(p, seed=7)
        arrays = spanned_arrays(p, inputs, device="cuda")
        before = module.launches_by["exact"]
        got = run(p, an, plan, arrays, lib)
        torch.cuda.synchronize()
        want = plain(p, an, plan, arrays)
        rtol = VERIFY_RTOL if _has_transcendental(p) else 0.0
        for o in p.outputs:
            ok, err = _compare(got[o].cpu().numpy(), want[o].cpu().numpy(),
                               rtol)
            n = module.launches_by["exact"] - before
            print(f"compare: {kname:7s} {label:28s} tile {plan.tile} "
                  f"max_abs_err {err:.3g} launches {n} "
                  f"{'OK' if ok else 'MISMATCH'}", flush=True)
            if not ok or n != 1:
                raise RuntimeError(f"{kname} kernel disagrees with its "
                                   f"plain version on {label}")
    for label, p, plan in stream_plans[:len(stream_cases)] + [
            (label + " (" + _routes(q) + ")", p, q)
            for label, (p, q) in other_route.items()
            if label in dict(stream_cases)]:
        lib = lib_of[st.stream_source(plan)]
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=7),
                                device="cuda")
        before = st.launches_by["exact"]
        got = st.run_stream(plan, arrays, lib)
        torch.cuda.synchronize()
        want = st.stream_plain(plan, arrays)
        for o in p.outputs:
            g, w = got[o].cpu().numpy(), want[o].cpu().numpy()
            ok, err = _compare(g, w, MXU_VERIFY_RTOL)
            ok = ok and bool(np.isfinite(g).all())
            n = st.launches_by["exact"] - before
            cfg = plan.last_config()
            print(f"compare: stream  {label:28s} tile {plan.tile} x "
                  f"{plan.threads} passes {_routes(plan) or '-'} banded "
                  f"{cfg['mxu_stages']} composed {cfg['composed']} "
                  f"max_abs_err {err:.3g} launches {n} "
                  f"{'OK' if ok else 'MISMATCH'} (MXU_VERIFY_RTOL)",
                  flush=True)
            if not ok or n != 1:
                raise RuntimeError(f"stream kernel disagrees with its plain "
                                   f"version on {label}")

    for label, p, chunks, plan in local_plans:
        lib = lib_of[st.stream_source(plan)]
        inputs = sft.load_input_arrays(p, seed=7)
        banded = bool(plan.mxu_plans)
        rtol = MXU_VERIFY_RTOL if banded else (
            VERIFY_RTOL if _has_transcendental(p) else 0.0)
        if label == "box-r2-banded" and sorted(plan.mxu_plans) != sorted(
                p.kernels):
            raise RuntimeError(f"{label}: not banded per stage "
                               f"({sorted(plan.mxu_plans)})")
        worst, launched = 0.0, 0
        for c in range(chunks):
            lo = c * plan.block - plan.halo_i
            slabs = chunk_slabs(p, inputs, lo, plan.extent())
            before = st.launches_by["local"]
            got = st.run_local_stream(plan, lo, slabs, lib)
            torch.cuda.synchronize()
            launched += st.launches_by["local"] - before
            want = st.local_stream_plain(plan, lo, slabs)
            for o in p.outputs:
                g = got[o].cpu().numpy()
                ok, err = _compare(g, want[o].cpu().numpy(), rtol)
                if banded:
                    ok = ok and bool(np.isfinite(g).all())
                worst = max(worst, err)
                if not ok:
                    raise RuntimeError(f"local stream kernel disagrees with "
                                       f"its plain version on {label}, "
                                       f"chunk {c} (max abs diff {err:.3g})")
        print(f"compare: local   {label:28s} chunks {chunks} Ic "
              f"{plan.block} h {plan.halo_i} tile {plan.tile} banded "
              f"{sorted(plan.mxu_plans)} max_abs_err {worst:.3g} launches "
              f"{launched} OK ({'MXU_VERIFY_RTOL' if banded else 'rtol %g' % rtol})",
              flush=True)
        if launched != chunks:
            raise RuntimeError(f"local stream kernel launched {launched} "
                               f"times over {chunks} chunks of {label}")

    for label, p, an, plan, src in group_plans[:len(group_cases)]:
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=7),
                                device="cuda")
        before = gp.launches_by["exact"]
        got = gp.run_group(p, an, plan, arrays, lib_of[src])
        torch.cuda.synchronize()
        want = gp.group_plain(p, an, plan, arrays)
        n = gp.launches_by["exact"] - before
        for o in p.outputs:
            ok, err = _compare(got[o].cpu().numpy(), want[o].cpu().numpy(),
                               0.0)
            print(f"compare: group   {label:28s} B {plan.B} groups "
                  f"{len(plan.groups)} tile {plan.tile} x {plan.threads} "
                  f"max_abs_err {err:.3g} launches {n} "
                  f"{'OK' if ok else 'MISMATCH'}", flush=True)
            if not ok or n != 1:
                raise RuntimeError(f"group kernel disagrees with its plain "
                                   f"version on {label}")

    # K3c: every ring spilled, whole domain, then K4 spilled chunk by chunk
    p, plan = local_cases[2][1], spill_small
    arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=7),
                            device="cuda")
    before = st.launches_by["spill"]
    got = st.run_stream(plan, arrays, lib_of[st.stream_source(plan)])
    torch.cuda.synchronize()
    want = st.stream_plain(plan, arrays)
    n = st.launches_by["spill"] - before
    for o in p.outputs:
        ok, err = _compare(got[o].cpu().numpy(), want[o].cpu().numpy(), 0.0)
        print(f"compare: spill   {p.name:28s} tile {plan.tile} spilled "
              f"{len(plan.spilled)} of {len(plan.raw_ring)} rings "
              f"({plan.spill_bytes()} B) smem {plan.smem_bytes()} B "
              f"max_abs_err {err:.3g} launches {n} "
              f"{'OK' if ok else 'MISMATCH'}", flush=True)
        if not ok or n != 1:
            raise RuntimeError(f"spilled stream kernel disagrees with its "
                               f"plain version on {p.name}")
    inputs = sft.load_input_arrays(lp, seed=7)
    launched, worst = 0, 0.0
    for c in range(4):
        lo = c * local_spill.block - local_spill.halo_i
        slabs = chunk_slabs(lp, inputs, lo, local_spill.extent())
        before = st.launches_by["spill"]
        got = st.run_local_stream(local_spill, lo, slabs,
                                  lib_of[st.stream_source(local_spill)])
        torch.cuda.synchronize()
        launched += st.launches_by["spill"] - before
        want = st.local_stream_plain(local_spill, lo, slabs)
        for o in lp.outputs:
            ok, err = _compare(got[o].cpu().numpy(), want[o].cpu().numpy(),
                               0.0)
            worst = max(worst, err)
            if not ok:
                raise RuntimeError(f"spilled local stream kernel disagrees "
                                   f"with its plain version, chunk {c}")
    print(f"compare: spill   {lp.name + ' local':28s} chunks 4 tile "
          f"{local_spill.tile} spilled {len(local_spill.spilled)} rings "
          f"max_abs_err {worst:.3g} launches {launched} OK", flush=True)
    if launched != 4:
        raise RuntimeError(f"spilled K4 launched {launched} times over 4 "
                           "chunks")

    # the reduced-precision modes: bf16 rings (K1, K5, K3a, K3c) bit for
    # bit, single-pass bf16 band passes (K3b) against their plain version
    # and apart from the split route (``_bf16_held``)
    for label, kernel, p, an, plan, src in bf16_small:
        run, plain, count, line, split = _bf16_kernel(
            pn, gp, st, kernel, p, an, plan)
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=7),
                                device="cuda")
        before = count()
        got = run(arrays, lib_of[src])
        torch.cuda.synchronize()
        n = count() - before
        want = plain(arrays)
        far = split(arrays) if split else None
        for o in p.outputs:
            ok, err, fig = _bf16_held(
                got[o].cpu().numpy(), want[o].cpu().numpy(),
                None if far is None else far[o].cpu().numpy())
            print(f"compare: bf16    {label:28s} {line} max_abs_err "
                  f"{err:.3g} launches {n} {'OK' if ok else 'MISMATCH'} "
                  f"{_held_text(fig)}", flush=True)
            if not ok or n != 1:
                raise RuntimeError(f"{kernel} kernel ({label}) disagrees "
                                   "with its plain version")

    # bf16 and f16 compute: per-cell plans bit for bit, banded ones by the
    # banded rule (``stream.bf16_compute_agree``); each kernel and plain
    # version timed (K3c's only timing: no main-path cell runs it)
    from stencilflow_tpu_torch.dtypes import to_torch_dtype
    for label, p, plan in cbf_small:
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=7),
                                device="cuda")
        lib = lib_of[st.stream_source(plan)]
        cd = plan.compute_dtype
        count = st.compute_key(plan)
        before = st.launches_by[count]
        got = st.run_stream(plan, arrays, lib)
        torch.cuda.synchronize()
        n = st.launches_by[count] - before
        t0 = time.perf_counter()
        want = st.stream_plain(plan, arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ms = _time_ms(lambda: st.run_stream(plan, arrays, lib), 5)
        bound_ms, bound_by = _bound(p, compute_dtype=cd)
        conv = (f", {len(p.kernels)} chained F.conv3d in {cd} "
                f"{_conv_chain_ms(p, 1, dtype=to_torch_dtype(plan.compute_narrow)):.4f} ms"
                if plan.packed else "")
        for o in p.outputs:
            ok, fig = st.bf16_compute_agree(want[o].cpu().numpy(),
                                            got[o].cpu().numpy(),
                                            bool(plan.mxu_plans))
            print(f"compare: {'bf16c' if cd == 'bfloat16' else 'f16c':7s} "
                  f"{label:28s} tile {plan.tile} x "
                  f"{plan.threads} smem {plan.smem_bytes()} B"
                  f"{' spilled %d rings' % len(plan.spilled) if plan.packed else ''}"
                  f"{', ' + _routes(plan) + ' passes' if plan.tkeys else ''}"
                  f" max_abs_err {fig['max_abs_err']:.3g} ({fig['share']:.4%}"
                  f" of cells equal) launches {n} "
                  f"{'OK' if ok else 'MISMATCH'} | {ms:.4f} ms, plain "
                  f"version {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}){conv}", flush=True)
            if not ok or n != 1:
                raise RuntimeError(f"{cd}-compute stream kernel ({label}) "
                                   "disagrees with its plain version")

    # compute types on programs typed otherwise, int32 and bool compute
    ct_rows = _ct_small(sft, st, ct_small, lib_of, smi)
    # programs typed bfloat16 and float16 (K3c bf16's row comes from here)
    narrow_k3c = _narrow_small(sft, pn, ov, gp, st, narrow_cases, lib_of,
                               smi)
    # K4 and K6 on a program typed float16
    _nk_small(sft, st, tl, nk_setup["small"], lib_of, smi)

    # K6, masked and fast
    for label, p, plan in tile_plans:
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=7),
                                device="cuda")
        before = tl.launches_by["exact"]
        got = tl.run_tile(plan, arrays, lib_of[tl.tile_source(plan)])
        torch.cuda.synchronize()
        want = tl.tile_plain(plan, arrays)
        n = tl.launches_by["exact"] - before
        rtol = VERIFY_RTOL if _has_transcendental(p) else 0.0
        for o in p.outputs:
            ok, err = _compare(got[o].cpu().numpy(), want[o].cpu().numpy(),
                               rtol)
            print(f"compare: tile    {label:28s} {plan.mode:6s} tile "
                  f"{plan.tile} smem {plan.smem_bytes()} B max_abs_err "
                  f"{err:.3g} launches {n} {'OK' if ok else 'MISMATCH'}",
                  flush=True)
            if not ok or n != 1:
                raise RuntimeError(f"tile kernel ({plan.mode}) disagrees "
                                   f"with its plain version on {label}")

    # -- 4. the main path at full size ---------------------------------------
    print(f"phase: 4 at {time.perf_counter() - t_run:.1f} s", flush=True)
    t4 = time.perf_counter()
    # kernel vs plain version at the main path's shapes (counted out)
    report = {}
    library = []     # (report key or cell, program, filter radius)
    for p, kname in ((jacobi8, "panel"), (hdiff8, "panel"),
                     (hotspot8, "panel"), (jacobi2, "overlap")):
        _, plan_cls, build_fn, run, plain = kernels[kname]
        an = sft.ChainAnalysis.run(p)
        plan = plan_cls.build(an)
        lib = build_fn(p, an, plan)
        # K1: packed and unpacked shared memory, resident blocks per SM;
        # K2: B, run, register window, blocks along i, threads
        smem = (f"smem {plan.smem_bytes(p)} B (unpacked "
                f"{plan.unpacked_bytes(p)}), {pn.occupancy(lib)} blocks "
                f"per SM, masked share {plan.masked_share(p):.3f}"
                if kname == "panel" else
                f"(B {plan.tile[0]}), R {plan.R} along j, window "
                f"{plan.window}, {plan.grid(p.dimensions)[0]} blocks along "
                f"i, {plan.threads} threads, "
                f"{pn.occupancy(lib)} blocks per SM, smem "
                f"{plan.smem_bytes(p)} B")
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=0),
                                device="cuda")
        got = run(p, an, plan, arrays, lib)
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        want = plain(p, an, plan, arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        ok, err = _compare(got[p.outputs[0]].cpu().numpy(),
                           want[p.outputs[0]].cpu().numpy(), 0.0)
        ms = _time_ms(lambda: run(p, an, plan, arrays, lib), 10)
        del got, want, arrays
        torch.cuda.empty_cache()
        bound_ms, bound_by = _bound(p)
        print(f"kernel: {kname} {p.name} tile {plan.tile} {smem}: "
              f"{ms:.3f} ms, plain version {plain_ms:.1f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), max_abs_err {err:.3g} "
              f"{'bit-equal to the plain version' if ok else 'MISMATCH'} "
              f"| {smi}", flush=True)
        if not ok:
            raise RuntimeError(f"{kname} kernel disagrees with its plain "
                               f"version on {p.name}")
        if kname in report:
            continue
        report[kname] = {
            "name": kname, "route": "cuda",
            "source": "stencilflow_tpu_torch/backend/codegen.py",
            "replaces": ("stencilflow_tpu/backend/panel.py:167"
                         if kname == "panel" else
                         "stencilflow_tpu/backend/overlap.py:99"),
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}
        library.append((kname, p, 1))
    stream_extra = {}
    # the split route's plain outputs, which the bf16 passes' kernel is
    # held apart from below
    split_plain = {}
    for label, p, plan in stream_plans[len(stream_cases):]:
        lib = lib_of[st.stream_source(plan)]
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=0),
                                device="cuda")
        got = st.run_stream(plan, arrays, lib)
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        want = st.stream_plain(plan, arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        split_plain[p.name] = want[p.outputs[0]].cpu().numpy()
        ok, err = _compare(got[p.outputs[0]].cpu().numpy(),
                           split_plain[p.name], MXU_VERIFY_RTOL)
        # the other route of the band passes, checked, then both timed in
        # turns (route, other, other, route)
        oplan = other_route[label][1]
        olib = lib_of[st.stream_source(oplan)]
        oout = st.run_stream(oplan, arrays, olib)
        ook, oerr = _compare(oout[p.outputs[0]].cpu().numpy(),
                             want[p.outputs[0]].cpu().numpy(),
                             MXU_VERIFY_RTOL)
        del oout
        turns = [_time_ms(lambda q=q, lb=lb: st.run_stream(q, arrays, lb), 5)
                 for q, lb in ((plan, lib), (oplan, olib), (oplan, olib),
                               (plan, lib))]
        ms = (turns[0] + turns[3]) / 2
        oms = (turns[1] + turns[2]) / 2
        # forced panel on the same inputs, where its planner fits
        forced = main_panel[p.name]
        if isinstance(forced, str):
            stream_extra[label] = f" | forced panel: refused ({forced})"
        else:
            an, pplan = forced
            plib = pn.build_panel(p, an, pplan)
            pout = pn.run_panel(p, an, pplan, arrays, plib)
            pok, _ = _compare(pout[p.outputs[0]].cpu().numpy(),
                              want[p.outputs[0]].cpu().numpy(),
                              MXU_VERIFY_RTOL)
            pms = _time_ms(lambda: pn.run_panel(p, an, pplan, arrays,
                                                plib), 2)
            stream_extra[label] = (
                f" | forced panel tile {pplan.tile} {pms:.3f} ms (within "
                f"MXU_VERIFY_RTOL: {'yes' if pok else 'NO'})")
            del pout
        del got, want, arrays
        torch.cuda.empty_cache()
        flops = plan.flops_per_cell() * p.total_elements
        bound_ms, bound_by = _bound(p)
        print(f"kernel: stream {label} tile {plan.tile} x {plan.threads} "
              f"threads, {_routes(plan)} passes, smem {plan.smem_bytes()} B "
              f"packed (unpacked {plan.unpacked_bytes()}), "
              f"{pn.occupancy(lib)} blocks per SM, "
              f"{plan.evaluations():.2f} evaluations a cell: {ms:.3f} ms "
              f"({p.total_elements / ms / 1e6:.2f} GCell/s; in turns "
              f"{turns[0]:.3f} / {turns[3]:.3f}), plain version "
              f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"transforms {flops / 1e9:.2f} GFLOP), max_abs_err {err:.3g} "
              f"{'OK' if ok else 'MISMATCH'} | {_routes(oplan)} passes "
              f"beside: tile {oplan.tile} x {oplan.threads}, smem "
              f"{oplan.smem_bytes()} B, {oms:.3f} ms (in turns "
              f"{turns[1]:.3f} / {turns[2]:.3f}), max_abs_err {oerr:.3g} "
              f"{'OK' if ook else 'MISMATCH'} | {smi}", flush=True)
        if not ok or not ook:
            raise RuntimeError(f"stream kernel disagrees with its plain "
                               f"version on {label}")
        key = "stream" if label == "box3d_256_8itr" else "stream_cross"
        report[key] = {
            "name": key, "route": "cuda",
            "source": "stencilflow_tpu_torch/backend/codegen.py",
            "replaces": "stencilflow_tpu/backend/stream.py:297",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}
        library.append((key, p, 2))

    # K3c on the deep cells (the route's spill-rung plans): kernel and
    # plain version bit for bit, the dense lowering's time beside, spill
    # traffic against the copy floor, the layout's loads and residency
    from stencilflow_tpu_torch.backend.dense import compile_chain
    from stencilflow_tpu_torch.config import H100_COPY_FLOOR
    for p in deep:
        plan = deep_plans[p.name]
        lib = lib_of[st.stream_source(plan)]
        inputs = sft.load_input_arrays(p, seed=0)
        arrays = spanned_arrays(p, inputs, device="cuda")
        got = st.run_stream(plan, arrays, lib)
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        want = st.stream_plain(plan, arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        o = p.outputs[0]
        ok, err = _compare(got[o].cpu().numpy(), want[o].cpu().numpy(), 0.0)
        del got, want
        ms = _time_ms(lambda: st.run_stream(plan, arrays, lib), 2)
        dense_fn = compile_chain(p)
        tensors = {k: torch.as_tensor(np.asarray(v)).cuda()
                   for k, v in inputs.items()}
        dense_ms = _time_ms(lambda: dense_fn(tensors), 1)
        del arrays, tensors
        plan.device_pool.clear()
        torch.cuda.empty_cache()
        bound_ms, bound_by = _bound(p)
        ntj, ntk = plan.grid()
        moved = plan.spill_traffic() * plan.steps() * ntj * ntk
        print(f"kernel: stream_spill {p.name} tile {plan.tile} smem "
              f"{plan.smem_bytes()} B, {plan.residency()} blocks per SM, "
              f"spilled {len(plan.spilled)} of {len(plan.raw_ring)} rings, "
              f"{len(plan.spill_layout().loads)} loads a step "
              f"({plan.spill_bytes() / 2 ** 30:.3f} GiB): {ms:.3f} ms "
              f"({p.total_elements / ms / 1e6:.2f} GCell/s, "
              f"{bound_ms / ms:.4f} of the bound {bound_ms:.4f} ms, "
              f"{bound_by}), spill traffic {moved / 1e9:.2f} GB a call at "
              f"{moved / ms / 1e6:.1f} GB/s ({moved / ms * 1e3 / H100_COPY_FLOOR:.3f} "
              f"of the copy floor), modelled {plan.spill_seconds() * 1e3:.1f} "
              f"ms | plain version {plain_ms:.1f} ms, max_abs_err {err:.3g} "
              f"{'OK' if ok else 'MISMATCH'} | dense {dense_ms:.3f} ms | {smi}",
              flush=True)
        if not ok:
            raise RuntimeError("spilled stream kernel disagrees with its "
                               f"plain version on {p.name}")
        if p is jacobi32:
            report["stream_spill"] = {
                "name": "stream_spill", "route": "cuda",
                "source": "stencilflow_tpu_torch/backend/codegen.py",
                "replaces": "stencilflow_tpu/backend/stream.py:658",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
    library.append(("stream_spill", jacobi32, 1))
    # the reduced-precision kernels at the full-width legs' shapes (counted
    # out): kernel and plain version, their times, the plan, the bound; the
    # plain versions' outputs stay for the legs
    bf16_plain = {}
    for key, (kernel, p, an, plan, src) in bf16_main.items():
        run, plain, _count, line, split = _bf16_kernel(
            pn, gp, st, kernel, p, an, plan)
        lib = lib_of[src]
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=0),
                                device="cuda")
        got = run(arrays, lib)
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        want = plain(arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        o = p.outputs[0]
        bf16_plain[key] = want[o].cpu().numpy()
        del want
        far = None
        if split is not None:   # computed above on the same inputs
            far = split_plain.get(p.name)
            if far is None:
                far = split(arrays)[o].cpu().numpy()
        ok, err, fig = _bf16_held(got[o].cpu().numpy(), bf16_plain[key], far)
        del got, far
        ms = _time_ms(lambda: run(arrays, lib),
                      2 if key == "stream_spill_bf16" else 10)
        del arrays
        if kernel == "stream":
            plan.device_pool.clear()
        torch.cuda.empty_cache()
        bound_ms, bound_by = _bound(p, getattr(plan, "mxu_precision",
                                               "split"))
        print(f"kernel: {key} {p.name} {line}: {ms:.3f} ms, plain version "
              f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"max_abs_err {err:.3g} {'OK' if ok else 'MISMATCH'} "
              f"{_held_text(fig)} | {smi}", flush=True)
        if not ok:
            raise RuntimeError(f"{key} disagrees with its plain version on "
                               f"{p.name}")
        report[key] = {
            "name": key, "route": "cuda",
            "source": "stencilflow_tpu_torch/backend/codegen.py",
            "replaces": {"panel": "stencilflow_tpu/backend/panel.py:167",
                         "group": "stencilflow_tpu/backend/group.py:195",
                         "stream": "stencilflow_tpu/backend/stream.py:297"}[
                             kernel],
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}
    # K6 on jacobi3d 512^3 x 2: masked, then fast (the route's mode,
    # tl.AUTO_MODE, whose entry the kernels line carries)
    arrays = spanned_arrays(jacobi2, sft.load_input_arrays(jacobi2, seed=0),
                            device="cuda")
    for mode in ("masked", "fast"):
        plan = tile_main[jacobi2.name, mode]
        lib = lib_of[tl.tile_source(plan)]
        got = tl.run_tile(plan, arrays, lib)
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        want = tl.tile_plain(plan, arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        o = jacobi2.outputs[0]
        ok, err = _compare(got[o].cpu().numpy(), want[o].cpu().numpy(), 0.0)
        ms = _time_ms(lambda: tl.run_tile(plan, arrays, lib), 10)
        del got, want
        torch.cuda.empty_cache()
        bound_ms, bound_by = _bound(jacobi2)
        print(f"kernel: tile {jacobi2.name} {mode} tile {plan.tile} smem "
              f"{plan.smem_bytes()} B, {pn.occupancy(lib)} blocks per SM: "
              f"{ms:.3f} ms, "
              f"plain version {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), max_abs_err {err:.3g} "
              f"{'OK' if ok else 'MISMATCH'} | {smi}", flush=True)
        if not ok:
            raise RuntimeError(f"tile kernel ({mode}) disagrees with its "
                               f"plain version on {jacobi2.name}")
        if mode == tl.AUTO_MODE:
            report["tile"] = {
                "name": "tile", "route": "cuda",
                "source": "stencilflow_tpu_torch/backend/codegen.py",
                "replaces": "stencilflow_tpu/backend/pallas.py:"
                            + ("123" if mode == "fast" else "104"),
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
    library.append(("tile", jacobi2, 1))
    del arrays
    torch.cuda.empty_cache()

    for label, p, an, plan, src in group_plans[len(group_cases):]:
        arrays = spanned_arrays(p, sft.load_input_arrays(p, seed=0),
                                device="cuda")
        lib = lib_of[src]
        got = gp.run_group(p, an, plan, arrays, lib)
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        want = gp.group_plain(p, an, plan, arrays)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        ok, err = _compare(got[p.outputs[0]].cpu().numpy(),
                           want[p.outputs[0]].cpu().numpy(), 0.0)
        ms = _time_ms(lambda: gp.run_group(p, an, plan, arrays, lib), 10)
        del got, want, arrays
        torch.cuda.empty_cache()
        bound_ms, bound_by = _bound(p)
        print(f"kernel: group {label} (rows) B {plan.B} g 8 tile {plan.tile} "
              f"x {plan.threads} segments {plan.segments} smem "
              f"{plan.smem_bytes(p)} B, {pn.occupancy(lib)} blocks per SM, "
              f"modelled {plan.seconds(p) * 1e3:.3f} ms: {ms:.3f} ms "
              f"({p.total_elements / ms / 1e6:.2f} GCell/s), plain version "
              f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"max_abs_err {err:.3g} {'OK' if ok else 'MISMATCH'} | {smi}",
              flush=True)
        if not ok:
            raise RuntimeError(f"group kernel disagrees with its plain "
                               f"version on {label}")
        if "group" not in report:   # jacobi2d's, the first 2-D cell
            report["group"] = {
                "name": "group", "route": "cuda",
                "source": "stencilflow_tpu_torch/backend/codegen.py",
                "replaces": "stencilflow_tpu/backend/group.py:195",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
    library.append(("group", jacobi2d, 1))
    for p, _ in mains2d:   # forced kernels beside the 2-D cells
        an, oplan, pplan = forced2d[p.name]
        inputs = {k: torch.as_tensor(np.asarray(v)).cuda()
                  if not p.inputs[k].is_scalar else v
                  for k, v in sft.load_input_arrays(p, seed=0).items()}
        fr = compile_chain_rows(p, "panel", device="cuda")[0]
        rms = _time_ms(lambda: fr(inputs), 5)
        rout = fr(inputs)[p.outputs[0]].cpu().numpy()
        if isinstance(oplan, str):
            stream_extra[p.name] = f" | forced overlap: refused ({oplan})"
        else:
            fo = ov.compile_chain_overlap(p, an, device="cuda")
            oms = _time_ms(lambda: fo(inputs), 5)
            oeq, _ = _compare(fo(inputs)[p.outputs[0]].cpu().numpy(), rout,
                              0.0)
            if not oeq:
                raise RuntimeError(f"{p.name}: forced overlap and forced "
                                   "rows+panel disagree")
            stream_extra[p.name] = (
                f" | forced overlap (unrotated) tile {oplan.tile} "
                f"{oms:.3f} ms")
        stream_extra[p.name] += (f" | forced rows+panel tile {pplan.tile} "
                                 f"{rms:.3f} ms")
        if p.name in stream2d:
            splan = stream2d[p.name]
            slib = lib_of[st.stream_source(splan)]
            sarr = spanned_arrays(p, sft.load_input_arrays(p, seed=0),
                                  device="cuda")
            sout = st.run_stream(splan, sarr, slib)[p.outputs[0]]
            if not _compare(sout.cpu().numpy().reshape(rout.shape), rout,
                            0.0)[0]:
                raise RuntimeError(f"{p.name}: the stream kernel and "
                                   "forced rows+panel disagree")
            sms = _time_ms(lambda: st.run_stream(splan, sarr, slib), 5)
            stream_extra[p.name] += (f" | stream kernel (packed) tile "
                                     f"{splan.tile} {sms:.3f} ms")
            del sarr, sout
        forced2d[p.name] = rout
        del inputs, fr
        torch.cuda.empty_cache()

    print(f"phase 4: the kernels against their plain versions took "
          f"{time.perf_counter() - t4:.1f} s", flush=True)
    t4 = time.perf_counter()
    route_ms = {}
    # the f32 routes' outputs and ms of the cells the bf16 legs run again
    f32_route = {}
    bf16_cells = {jacobi8.name, jacobi32.name, jacobi2d.name, box256.name}
    pn.launches_by["exact"] = 0
    ov.launches_by["exact"] = 0
    st.launches_by["exact"] = 0
    st.launches_by["local"] = 0
    st.launches_by["spill"] = 0
    gp.launches_by["exact"] = 0
    tl.launches_by["exact"] = 0
    for p, want_backend, backend in (
            [(p, w, "auto") for p, w in mains]
            + [(p, "stream", "auto") for p in deep]
            + [(jacobi2, "tile", "tile"), (hdiff8, "tile", "tile")]):
        spilled_before = st.launches_by["spill"]
        t_cell = time.perf_counter()
        res = run_program(p, device="cuda", backend=backend,
                          repetitions=3 if p.name in deep_names else 20,
                          save_results=False, log_level=0)
        if res.backend != want_backend:
            raise RuntimeError(f"{p.name}: backend {res.backend}, expected "
                               f"{want_backend}")
        if p.name in deep_names and (not deep_plans[p.name].packed
                          or st.launches_by["spill"] - spilled_before != 4):
            raise RuntimeError(f"{p.name}: the spilled stream kernel ran "
                               f"{st.launches_by['spill'] - spilled_before} "
                               "times over 4 calls")
        dense = run_program(p, device="cuda", backend="dense",
                            repetitions=2, save_results=False, log_level=0)
        rtol = MXU_VERIFY_RTOL if p is box256 or p is cross256 else 0.0
        for o in p.outputs:
            ok, err = _compare(res.outputs[o], dense.outputs[o], rtol)
            if not ok or not np.isfinite(res.outputs[o]).all():
                raise RuntimeError(f"{p.name}: {res.backend} disagrees "
                                   f"with dense (max abs diff {err:.3g})")
        oracle = p.name in oracle_of
        waited = 0.0
        if oracle:   # run_program's own check (VERIFY_RTOL, banded: MXU)
            t_wait = time.perf_counter()
            want = oracle_of[p.name].result()
            waited = time.perf_counter() - t_wait
            for o in p.outputs:
                if not _compare(res.outputs[o], np.asarray(want[o]),
                                rtol or VERIFY_RTOL)[0]:
                    raise RuntimeError(f"{p.name}: {res.backend} disagrees "
                                       "with the numpy oracle")
            del want
        if p.name in forced2d and not _compare(
                res.outputs[p.outputs[0]], forced2d[p.name], 0.0)[0]:
            raise RuntimeError(f"{p.name}: {res.backend} disagrees with "
                               "forced rows+panel")
        cells = p.total_elements
        extra = stream_extra.get(p.name, "")
        if p.name in deep_names:
            plan = deep_plans[p.name]
            extra = (f" | tile {plan.tile}, spilled {len(plan.spilled)} of "
                     f"{len(plan.raw_ring)} rings, smem "
                     f"{plan.smem_bytes()} B, spill buffer "
                     f"{plan.spill_bytes() / 2 ** 30:.3f} GiB")
        if backend == "tile":
            plan = tile_main[p.name, tl.AUTO_MODE]
            extra = (f" | {plan.mode}, tile {plan.tile}, smem "
                     f"{plan.smem_bytes()} B | "
                     f"route {route_ms[p.name][0]} "
                     f"{route_ms[p.name][1]:.3f} ms")
        else:
            route_ms[p.name] = (res.backend, res.wall_time_s * 1e3)
            if p.name in bf16_cells:
                f32_route[p.name] = (res.outputs[p.outputs[0]],
                                     res.backend, res.wall_time_s * 1e3)
        print(f"main: {p.name} backend {res.backend} "
              f"{res.wall_time_s * 1e3:.3f} ms "
              f"({cells / res.wall_time_s / 1e9:.2f} GCell/s) | dense "
              f"{dense.wall_time_s * 1e3:.3f} ms "
              f"({cells / dense.wall_time_s / 1e9:.2f} GCell/s) | "
              f"{'within MXU_VERIFY_RTOL of' if rtol else 'equal to'} "
              f"dense, oracle "
              f"{f'OK (waited {waited:.1f} s)' if oracle else 'skipped'}"
              f"{extra} | cell {time.perf_counter() - t_cell:.1f} s | {smi}",
              flush=True)
        del res, dense
        torch.cuda.empty_cache()
    oracle_pool.shutdown()
    print(f"phase 4: the main path took {time.perf_counter() - t4:.1f} s",
          flush=True)
    t4 = time.perf_counter()
    _bf16_legs(sft, pn, gp, st, run_program, compile_chain_rows, bf16_main,
               bf16_plain, f32_route, report, smi,
               (jacobi8, jacobi32, jacobi2d, box256))
    report.update(_compute_bf16_legs(sft, st, cbf_main, lib_of, smi))
    report.update(_ct_legs(sft, st, ct_mains, lib_of, smi))
    report.update(ct_rows)
    report.update(_narrow_legs(sft, pn, ov, gp, st, run_program,
                               narrow_mains, lib_of, smi))
    report["stream_spill_typed_bf16"] = narrow_k3c
    report.update(_nk_tiles(sft, tl, run_program, nk_setup["tiles"], lib_of,
                            smi, inputs_memo, jacobi2))
    print(f"phase 4: the bf16 legs took {time.perf_counter() - t4:.1f} s",
          flush=True)
    # the library yardstick, after the main path (cuDNN state stays out
    # of the kernels' timings)
    for key, p, radius in library:
        lib_ms = _conv_chain_ms(p, radius)
        if key in report:
            report[key]["library_ms"] = lib_ms
        nd = len(p.raw_dimensions)
        print(f"library: {p.name} {len(p.kernels)} chained F.conv{nd}d "
              f"(filter {2 * radius + 1}^{nd}, TF32 off) {lib_ms:.3f} ms "
              f"| {smi}", flush=True)
        torch.cuda.empty_cache()
    report["panel"]["launches"] = pn.launches_by["exact"]
    report["overlap"]["launches"] = ov.launches_by["exact"]
    report["stream"]["launches"] = st.launches_by["exact"]
    report["stream_cross"]["launches"] = st.launches_by["exact"]
    report["group"]["launches"] = gp.launches_by["exact"]
    report["stream_spill"]["launches"] = st.launches_by["spill"]
    report["tile"]["launches"] = tl.launches_by["exact"]
    if st.launches_by["local"]:
        raise RuntimeError("the in-core main path launched the local "
                           "stream kernel")
    # the autotuned main path on cross3d 256^3 x 8, extent 2
    _autotune_leg(sft, st, pn, ov, gp, tl, cross256, autotune_build_s, smi,
                  run_program)

    # -- 5. the out-of-core path ---------------------------------------------
    print(f"phase: 5 at {time.perf_counter() - t_run:.1f} s", flush=True)
    inputs_memo.clear()
    report["local_stream"] = _outofcore(sft, st, pn, ov, gp, oc_cells,
                                        oc_plans, lib_of, smi, run_program)
    report["local_stream_typed_bf16"] = _nk_outofcore(
        sft, st, pn, ov, gp, tl, nk_setup["oc"], lib_of, smi, run_program,
        inputs_memo, jacobi1024)
    report["local_stream_bf16"] = _outofcore_bf16(
        sft, st, pn, ov, gp, tl, box512, 4, oc_bf16, lib_of, smi, run_program)
    inputs_memo.clear()
    inputs_memo.on = False

    # -- 6. the measurement path ---------------------------------------------
    print(f"phase: 6 at {time.perf_counter() - t_run:.1f} s", flush=True)
    report.update(_measurement(pn, smi))
    report.update(_design_probes(ov, smi))
    for name, entry in report.items():
        if entry["launches"] < 1:
            raise RuntimeError(f"the main path never launched {name}")

    # -- 7. the solver entry points ------------------------------------------
    print(f"phase: 7 at {time.perf_counter() - t_run:.1f} s", flush=True)
    _solvers(sft, solver_progs, smi, report["panel"]["ms"])
    _nk_solvers(sft, pn, ov, gp, tl, st, nk_setup["solvers"], smi)

    # -- 8. the simulator ------------------------------------------------------
    print(f"phase: 8 at {time.perf_counter() - t_run:.1f} s", flush=True)
    _simulator(sft, run_program, smi)

    # -- 9. the sharded engine -------------------------------------------------
    print(f"phase: 9 at {time.perf_counter() - t_run:.1f} s", flush=True)
    t9 = time.perf_counter()
    inputs_memo.on = True
    report["local_stream_shard"] = _sharded(sft, st, pn, ov, gp, tl,
                                            sharded_setup, smi)
    report["local_stream_segment"] = _pipeline(sft, st, pn, ov, gp, tl,
                                               sharded_setup, smi)
    report.update(_k4_bf16(sft, st, pn, ov, gp, tl, sharded_setup, smi))
    report.update(_nk_sharded(sft, st, pn, ov, gp, tl, nk_setup["dist"], smi,
                              inputs_memo, jacobi8))
    report["local_stream_shard_overlap"] = _overlap(
        sft, st, pn, ov, gp, tl, sharded_setup, smi)
    inputs_memo.clear()
    import tempfile
    with tempfile.TemporaryDirectory(prefix="sft_multihost_") as tmp:
        _multihost(sft, sharded_setup, smi, tmp)
    print(f"sharded: phase 9 took {time.perf_counter() - t9:.1f} s | {smi}",
          flush=True)

    bad = [m for m in sys.modules
           if m == "jax" or m.startswith(("jax.", "stencilflow_tpu."))
           or m == "stencilflow_tpu"]
    if bad:
        raise RuntimeError(f"imported the JAX side: {bad[:5]}")
    print(f"phase: end at {time.perf_counter() - t_run:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
