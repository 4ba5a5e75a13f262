"""Point-to-point transfers between the processes of a multi-host mesh.

The counterpart of the ``ppermute``s that carry the JAX package's halo
slabs and pipeline hops between hosts.  The transport is gloo
(``torch.distributed``'s CPU backend): every message is a contiguous
host buffer, so a slab of a CUDA shard is first copied into a pinned
host buffer (the producing stream synchronized before the send) and a
received buffer is copied onto its shard's device.  Every shard still
computes on its own device; only the bytes that cross processes stage
through the host.  NCCL between distinct GPUs is not built here.

A ``Transfers`` is one round: every process declares the same moves in
the same order (each move takes the next tag, on both sides alike), acts
on the ones it takes part in (a send or a receive), and ``run`` posts
them all (``isend`` / ``irecv``) and waits for all of them, so no two
ranks can wait on each other.  A round with ``headers`` first sends each
payload's shape and type, for receivers that cannot compute them.

``init_hosts`` joins the process group the CLI's ``--coordinator``,
``--num-hosts`` and ``--host-id`` name; ``stats`` counts what crossed
processes (payload bytes, messages, the seconds in ``run``).
"""
from __future__ import annotations

import datetime
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

TRANSPORT = "gloo, host-staged"
# seconds a rendezvous or a transfer waits for a peer before it raises
TIMEOUT_S = 300

# what crossed processes in this process (reset it to 0 to read a span)
stats: Dict[str, float] = {"bytes_sent": 0, "bytes_received": 0,
                           "messages": 0, "seconds": 0.0}

_DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
           torch.bool]
_MAX_DIMS = 8


def init_hosts(coordinator: str, num_hosts: int, host_id: int) -> None:
    """Join the gloo process group of ``num_hosts`` processes whose
    rendezvous is ``coordinator`` ("host:port"), as rank ``host_id``."""
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_hosts,
        rank=host_id, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


class Transfers:
    """One round of point-to-point moves between the processes of
    ``mesh`` (the default process group's ranks)."""

    def __init__(self, mesh, headers: bool = False):
        self.mesh, self.headers = mesh, headers
        self.tag = 0
        self._sends: List[Tuple[int, int, torch.Tensor]] = []
        # (rank, tag, (shape, dtype) or None, sink, pinned)
        self._recvs: List[tuple] = []

    def move(self, src, dst, value: Optional[torch.Tensor],
             sink: Callable[[torch.Tensor], None],
             like: Optional[torch.Tensor] = None) -> None:
        """Declare the move of position ``src``'s ``value`` to position
        ``dst``, whose ``sink`` takes it: a local copy where this process
        holds both, a send or a receive where it holds one, nothing where
        it holds neither.  Every process declares the same moves in the
        same order, its own or not: the count is the move's tag."""
        self.tag += 1
        tag, mesh = self.tag, self.mesh
        mine_src, mine_dst = mesh.is_local(src), mesh.is_local(dst)
        if mine_src and mine_dst:
            sink(value)
        elif mine_src:
            self._sends.append((mesh.owner(dst), tag, value))
        elif mine_dst:
            # ``like`` gives the payload's shape and type, else the
            # round's headers do; a CUDA destination takes a pinned buffer
            meta = None if like is None else (tuple(like.shape), like.dtype)
            self._recvs.append((mesh.owner(src), tag, meta, sink,
                                mesh.device(dst).type == "cuda"))

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            return buf
        return t.contiguous()

    def run(self) -> None:
        """Post every declared send and receive, wait for all of them and
        hand each received buffer to its sink."""
        if not self._sends and not self._recvs:
            return
        import torch.distributed as dist
        t0 = time.perf_counter()
        staged = [(r, tag, self._staged(t)) for r, tag, t in self._sends]
        for dev in {t.device for _r, _tag, t in self._sends
                    if t.device.type == "cuda"}:
            torch.cuda.current_stream(dev).synchronize()
        work = []
        if self.headers:
            for r, tag, t in staged:
                head = torch.zeros(_MAX_DIMS + 2, dtype=torch.int64)
                head[0], head[1] = t.dim(), _DTYPES.index(t.dtype)
                head[2:2 + t.dim()] = torch.tensor(t.shape,
                                                   dtype=torch.int64)
                work.append(dist.isend(head, r, tag=2 * tag))
            heads = []
            for r, tag, meta, _sink, _pin in self._recvs:
                head = torch.empty(_MAX_DIMS + 2, dtype=torch.int64)
                heads.append((head, dist.irecv(head, r, tag=2 * tag)))
        for r, tag, t in staged:
            work.append(dist.isend(_bytes(t), r, tag=2 * tag + 1))
        bufs = []
        for k, (r, tag, meta, _sink, pinned) in enumerate(self._recvs):
            if meta is None:
                head, w = heads[k]
                w.wait()
                nd = int(head[0])
                meta = (tuple(int(x) for x in head[2:2 + nd]),
                        _DTYPES[int(head[1])])
            buf = torch.empty(meta[0], dtype=meta[1],
                              pin_memory=pinned and torch.cuda.is_available())
            work.append(dist.irecv(_bytes(buf), r, tag=2 * tag + 1))
            bufs.append(buf)
        for w in work:
            w.wait()
        for (_r, _tag, _meta, sink, _pin), buf in zip(self._recvs, bufs):
            sink(buf)
        stats["bytes_sent"] += sum(t.numel() * t.element_size()
                                   for _r, _tag, t in staged)
        stats["bytes_received"] += sum(b.numel() * b.element_size()
                                       for b in bufs)
        stats["messages"] += len(staged) + len(bufs)
        stats["seconds"] += time.perf_counter() - t0
        self._sends, self._recvs = [], []
