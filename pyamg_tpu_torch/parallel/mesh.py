"""The mesh of ranks, its launcher and the exchange layer.

Port of ``make_mesh`` (``pyamg_tpu/parallel/sharding.py``).  The JAX
package is single-controller: one process drives every device of a mesh
and XLA inserts the collectives.  Here every rank is a process that runs
the same code on its own slab of each level (SPMD), and the operators and
reductions communicate explicitly through ``torch.distributed``:

* NCCL takes the device tensors themselves, one rank a card;
* gloo takes host tensors: a CUDA tensor is staged through pinned host
  memory, explicitly, for ranks that share one card; CPU ranks use it
  directly.

How a buffer is copied follows from the backend, never from a failure:
NCCL with a CPU tensor raises.  The layer counts the collectives it issues,
the bytes this rank receives in them and the host seconds they take
(``counters``).  The seconds cover staging, the call and the wait for the
other ranks; a CUDA tensor bound for gloo first waits for the work that
makes it, outside the clock.  An NCCL call is asynchronous, so its
seconds are the host's issue time only.

:func:`launch` starts ``nprocs`` ranks with the ``spawn`` start method
over a ``file://`` store in a fresh temporary directory (no TCP port), and
returns their results in rank order.

Examples
--------
>>> from pyamg_tpu_torch.parallel import make_mesh
>>> mesh = make_mesh(1, device="cpu")     # no process group: one rank
>>> mesh.size, mesh.rank, mesh.distributed
(1, 0, False)
"""

from __future__ import annotations

import datetime
import inspect
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["Mesh", "Layout", "Exchange", "make_mesh", "one_rank_mesh",
           "launch", "counters", "reset_counters"]

# collectives issued, payload bytes received and seconds spent in them by
# this rank
counters = {"collectives": 0, "bytes": 0, "seconds": 0.0}

_RANK_DEVICE = None      # the device :func:`launch` gave this rank
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
_SUBGROUPS = {}          # n -> the process group of the first n ranks


def reset_counters():
    """Set the exchange counters to 0."""
    counters.update(collectives=0, bytes=0, seconds=0.0)


def _count(nbytes, t0):
    counters["collectives"] += 1
    counters["bytes"] += int(nbytes)
    counters["seconds"] += time.perf_counter() - t0


class Mesh:
    """A 1-D mesh of ranks: the process group, this rank's place in it,
    the axis name and this rank's device.

    ``distributed`` is False for the one-rank mesh of a process without a
    process group; its collectives are identities.  A rank outside a mesh
    of the first ``n`` ranks has ``rank`` None and must not use it."""

    def __init__(self, group, rank, size, axis_name, device, backend):
        self.group = group
        self.rank = rank
        self.size = int(size)
        self.axis_name = axis_name
        self.device = torch.device(device)
        self.backend = backend

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def __repr__(self):
        return (f"Mesh(size={self.size}, rank={self.rank}, "
                f"axis={self.axis_name!r}, device={self.device}, "
                f"backend={self.backend})")

    # -- buffers on the wire ---------------------------------------------
    def _wire(self, t):
        """The buffer a collective takes for ``t``: complex tensors as
        their real views; a CUDA tensor staged through pinned host memory
        for gloo; NCCL refuses host tensors."""
        t = t.contiguous()
        if t.is_complex():
            t = torch.view_as_real(t)
        if self.backend == "nccl" and not t.is_cuda:
            raise ValueError("the NCCL backend takes CUDA tensors; this one "
                             f"is on {t.device}")
        if self.backend != "nccl" and t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            return h
        return t

    def _back(self, w, like, device=None):
        """``w`` off the wire, on ``device`` (by default ``like``'s) and in
        ``like``'s dtype kind."""
        if like.is_complex():
            w = torch.view_as_complex(w)
        device = like.device if device is None else device
        return w.to(device) if w.device != device else w

    def _empty(self, shape, like):
        """An empty wire buffer shaped for ``like``'s kind."""
        dt = like.real.dtype if like.is_complex() else like.dtype
        shape = tuple(shape) + ((2,) if like.is_complex() else ())
        dev = like.device if self.backend == "nccl" else torch.device("cpu")
        return torch.empty(shape, dtype=dt, device=dev)

    # -- collectives -------------------------------------------------------
    def _clock(self, t):
        """The start of a collective on ``t``: a CUDA tensor bound for
        gloo first waits for the device work that makes it."""
        if t.is_cuda and self.backend != "nccl":
            torch.cuda.current_stream(t.device).synchronize()
        return time.perf_counter()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (``op="max"``: the largest) of ``t`` over the ranks (a
        new tensor)."""
        if not self.distributed:
            return t
        t0 = self._clock(t)
        w = self._wire(t)
        w = w.clone() if w is t or w.data_ptr() == t.data_ptr() else w
        dist.all_reduce(w, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        out = self._back(w, t)
        _count(w.numel() * w.element_size(), t0)
        return out

    def all_gather(self, t: torch.Tensor, host: bool = False) -> torch.Tensor:
        """Every rank's ``t`` (one shape on all), concatenated along dim 0
        in rank order, on ``t``'s device (``host``: on the CPU).  NCCL
        gathers into one tensor; gloo sends the slab to every rank in one
        all-to-all (its ring all-gather takes a round trip per rank)."""
        if not self.distributed:
            return t.cpu() if host else t
        t0 = self._clock(t)
        w = self._wire(t)
        if self.backend == "nccl":
            out = torch.empty((self.size * w.shape[0],) + tuple(w.shape[1:]),
                              dtype=w.dtype, device=w.device)
            dist.all_gather_into_tensor(out, w, group=self.group)
        else:
            out = torch.empty((self.size * w.shape[0],) + tuple(w.shape[1:]),
                              dtype=w.dtype)
            dist.all_to_all_single(out, w.repeat((self.size,)
                                                 + (1,) * (w.dim() - 1)),
                                   group=self.group)
        out = self._back(out, t, torch.device("cpu") if host else None)
        _count((self.size - 1) * w.numel() * w.element_size(), t0)
        return out

    def all_to_all(self, send: torch.Tensor, send_counts, recv_counts):
        """Rows ``send[...]`` split along dim 0 by ``send_counts`` go to
        the ranks in order; returns the rows received, by ``recv_counts``
        in rank order."""
        rest = tuple(send.shape[1:])
        if not self.distributed or self.size == 1:
            return send
        t0 = self._clock(send)
        w = self._wire(send)
        out = self._empty((int(sum(recv_counts)),) + rest, send)
        dist.all_to_all_single(out, w, [int(c) for c in recv_counts],
                               [int(c) for c in send_counts],
                               group=self.group)
        per_row = out[:1].numel() * out.element_size()
        got = self._back(out, send)
        _count((sum(recv_counts) - recv_counts[self.rank]) * per_row, t0)
        return got

    def all_gather_object(self, obj):
        """Every rank's picklable ``obj``, in rank order."""
        if not self.distributed:
            return [obj]
        t0 = time.perf_counter()
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        _count(0, t0)
        return out


class Exchange:
    """A fixed pattern of transfers between the ranks of a mesh, run as one
    ``all_to_all_single``: this rank sends rows ``send_idx`` of its slab,
    ``send_counts[p]`` of them to rank p in order, and receives
    ``recv_counts[p]`` rows from rank p."""

    def __init__(self, mesh, send_idx, send_counts, recv_counts):
        self.mesh = mesh
        self.send_idx = send_idx
        self.send_counts = [int(c) for c in send_counts]
        self.recv_counts = [int(c) for c in recv_counts]

    @property
    def n_recv(self) -> int:
        return sum(self.recv_counts)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The rows the other ranks send for ``x``, in rank order."""
        return self.mesh.all_to_all(x[self.send_idx], self.send_counts,
                                    self.recv_counts)

    def reverse(self, vals: torch.Tensor, n_local: int) -> torch.Tensor:
        """The transpose of :meth:`__call__`: ``vals`` (rows in the order
        they were received) go back to their owners, which sum them into
        their rows; returns this rank's ``(n_local, ...)`` sums."""
        back = self.mesh.all_to_all(vals, self.recv_counts, self.send_counts)
        out = vals.new_zeros((n_local,) + tuple(vals.shape[1:]))
        return out.index_add_(0, self.send_idx, back)


class Layout:
    """Where a level's vectors live on a mesh: row-sharded (``n`` divisible
    by the ranks; this rank holds rows ``start .. start + nl``) or whole on
    every rank.  Its reductions and gathers are the level's."""

    def __init__(self, mesh: Mesh, n: int, sharded: bool):
        self.mesh, self.n = mesh, int(n)
        self.sharded = bool(sharded)
        if self.sharded and self.n % mesh.size:
            raise ValueError(f"{self.n} rows do not divide over "
                             f"{mesh.size} ranks")
        self.nl = self.n // mesh.size if self.sharded else self.n
        self.start = mesh.rank * self.nl if self.sharded else 0
        self._halos = {}

    def __repr__(self):
        return (f"Layout(n={self.n}, sharded={self.sharded}, "
                f"rows={self.start}..{self.start + self.nl})")

    def local(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole vector (dim 0)."""
        if not self.sharded:
            return v
        return v[self.start:self.start + self.nl].contiguous()

    def full(self, v: torch.Tensor) -> torch.Tensor:
        """The whole vector from this rank's rows (a collective)."""
        return self.mesh.all_gather(v) if self.sharded else v

    def dot(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        d = torch.vdot(u, v)
        return self.mesh.all_reduce(d) if self.sharded else d

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        """The 2-norm of the whole vector (``vector_norm`` when whole)."""
        if not self.sharded:
            return torch.linalg.vector_norm(v)
        return torch.sqrt(self.mesh.all_reduce(v.abs().square().sum()))

    def halo(self, lo: int, hi: int) -> "RowHalo":
        """The exchange that gives every rank the ``lo`` rows before its
        slab and the ``hi`` rows after it (cached)."""
        key = (int(lo), int(hi))
        if key not in self._halos:
            self._halos[key] = RowHalo(self, *key)
        return self._halos[key]


class RowHalo:
    """Banded neighbour exchange of a row-sharded layout: :meth:`extend`
    returns ``lo + nl + hi`` rows around this rank's slab, zero beyond the
    first and the last row.  Each rank sends each other rank exactly the
    rows that rank reads (one ``all_to_all_single``)."""

    def __init__(self, layout: Layout, lo: int, hi: int):
        self.layout, self.lo, self.hi = layout, lo, hi
        mesh, nl, n = layout.mesh, layout.nl, layout.n
        r = mesh.rank

        def window(p):
            s = p * nl
            return max(s - lo, 0), min(s + nl + hi, n)

        def part(p, q):
            # rows of rank q's slab that rank p reads
            a, b = window(p)
            return max(a, q * nl), min(b, (q + 1) * nl)

        send, send_counts, recv_counts = [], [], []
        for p in range(mesh.size):
            if p == r:
                send_counts.append(0)
                recv_counts.append(0)
                continue
            a, b = part(p, r)
            send_counts.append(max(b - a, 0))
            if b > a:
                send.append(torch.arange(a - r * nl, b - r * nl))
            a, b = part(r, p)
            recv_counts.append(max(b - a, 0))
        idx = torch.cat(send) if send else torch.zeros(0, dtype=torch.long)
        self.exchange = Exchange(mesh, idx.to(mesh.device), send_counts,
                                 recv_counts)
        a, b = window(r)
        self.n_left = r * nl - a             # rows received from the left
        self.n_right = b - (r + 1) * nl

    def extend(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (this rank's rows, dim 0) with its halo rows around it."""
        recv = self.exchange(x)
        rest = tuple(x.shape[1:])
        parts = []
        if self.lo > self.n_left:
            parts.append(x.new_zeros((self.lo - self.n_left,) + rest))
        parts += [recv[:self.n_left], x, recv[self.n_left:]]
        if self.hi > self.n_right:
            parts.append(x.new_zeros((self.hi - self.n_right,) + rest))
        return torch.cat(parts)


def _rank_device(backend):
    """This rank's device in a group that :func:`launch` did not start."""
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return torch.device("cuda", local % torch.cuda.device_count())
    return torch.device("cuda")


def make_mesh(n_devices=None, axis_name: str = "rows", device=None) -> Mesh:
    """A 1-D mesh over the ranks of the default process group, or over its
    first ``n_devices`` ranks (every rank of the group must make it).

    Without a process group, ``n_devices`` in (None, 1) gives the one-rank
    mesh whose collectives are identities (the JAX package's
    ``make_mesh(1)``); more raises.  ``device`` is this rank's device: by
    default the one :func:`launch` gave the rank, ``cuda:<local rank>``
    under NCCL, else ``"cuda"``."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        n = world if n_devices is None else int(n_devices)
        if n > world or n < 1:
            raise ValueError(f"requested {n} devices, have {world}")
        backend = dist.get_backend()
        if n == world:
            group = dist.group.WORLD
        else:
            if n not in _SUBGROUPS:
                _SUBGROUPS[n] = dist.new_group(list(range(n)))
            group = _SUBGROUPS[n]
        rank = dist.get_rank()
        dev = device if device is not None else (
            _RANK_DEVICE if _RANK_DEVICE is not None
            else _rank_device(backend))
        return Mesh(group, rank if rank < n else None, n, axis_name, dev,
                    backend)
    if n_devices not in (None, 1):
        raise ValueError(
            f"requested {n_devices} devices, have 1: no process group is "
            "initialized; start the ranks with pyamg_tpu_torch.parallel."
            "launch (or torch.distributed.init_process_group)")
    return one_rank_mesh(device if device is not None else "cuda", axis_name)


def one_rank_mesh(device="cuda", axis_name: str = "rows") -> Mesh:
    """The one-rank mesh on ``device`` whose collectives are identities,
    in or outside a process group."""
    return Mesh(None, 0, 1, axis_name, device, None)


def _rank_main(rank, nprocs, backend, device, init, timeout, call, q):
    """One rank of :func:`launch`: join the group, run ``fn(mesh, *args)``
    (pickled in the file ``call``) and put ``(rank, ok, pickled result or
    traceback)`` on ``q``."""
    global _RANK_DEVICE
    try:
        torch.set_num_threads(1)
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        if backend == "nccl":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        else:
            dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kw = {}
        if backend == "nccl" and "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            kw["device_id"] = dev
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=nprocs,
            timeout=datetime.timedelta(seconds=timeout), **kw)
        _RANK_DEVICE = dev
        out = fn(make_mesh(), *args)
        dist.barrier()
        q.put((rank, True, pickle.dumps(out)))
    except BaseException:                          # noqa: BLE001
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, nprocs: int, backend: str = "gloo", device="cuda", args=(),
           timeout: float = 600.0):
    """Run ``fn(mesh, *args)`` on ``nprocs`` new ranks and return their
    results in rank order.

    Each rank is a process started with the ``spawn`` start method (``fn``
    and ``args`` must pickle: a module-level function), joined to a group
    of ``backend`` through a ``file://`` store in a fresh temporary
    directory, with one host thread (``torch.set_num_threads(1)`` and the
    OpenMP and BLAS thread variables at 1) and its device set: under
    NCCL ``cuda:<rank>``, under gloo ``device`` (``"cpu"`` for CPU ranks;
    ``"cuda:0"`` for ranks that share one card).  Raises RuntimeError
    with the traceback when a rank raises or dies, TimeoutError when
    ``timeout`` seconds pass; either way every rank is stopped."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        # the call goes by file: a process's arguments go down a pipe that
        # blocks start() until the new process has unpickled them
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, nprocs, backend, str(device), init,
                                   timeout, call, q))
                 for r in range(nprocs)]
        # one host thread a rank: the ranks' numpy and scipy calls would
        # otherwise each start a thread pool the size of the machine
        saved = {k: os.environ.get(k) for k in _THREAD_VARS}
        os.environ.update(dict.fromkeys(_THREAD_VARS, "1"))
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        results = {}
        deadline = time.monotonic() + timeout
        try:
            while len(results) < nprocs:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"launch: {nprocs - len(results)} of "
                                       f"{nprocs} ranks still running after "
                                       f"{timeout} s")
                try:
                    rank, ok, val = q.get(timeout=min(left, 0.5))
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in results and p.exitcode not in (None, 0):
                            raise RuntimeError(f"rank {r} died (exit code "
                                               f"{p.exitcode})") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} raised:\n{val}")
                results[rank] = pickle.loads(val)
        finally:
            for p in procs:
                p.join(timeout=5 if len(results) == nprocs else 0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
                if p.is_alive():
                    p.kill()
                    p.join()
            q.close()
    return [results[r] for r in range(nprocs)]
