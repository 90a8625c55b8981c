"""Block decomposition of the grid over processes and threads.

Port of :mod:`cice4_tpu.parallel.mesh`.  The JAX package shards every
field over a 2D device mesh and lets GSPMD insert the communication.
PyTorch has no partitioner, so the port decomposes explicitly: the
global ``(ny, nx)`` grid is cut into the contiguous ``ny/py x nx/px``
blocks of a near-square ``(py, px)`` mesh (the blocks of JAX's
``spatial_spec``), each block runs the model step on its own tensors,
and every non-local operation is an explicit exchange or reduction
through this module:

* the blocks of the mesh are owned by processes, contiguously in
  row-major block order; one process owning every block is the analogue
  of JAX's ``--xla_force_host_platform_device_count``, one block per
  process that of ``jax.distributed``;
* the blocks a process owns run in lockstep, one thread each
  (:meth:`Mesh.run`), and in turn: one block thread runs at a time and
  hands the turn to the next at each communication call, so that the
  threads never contend for the interpreter (the card's launches are
  issued one block after another, as one thread would); a message
  between two of them is a tensor handed over in memory, one between
  processes goes by ``torch.distributed``
  point-to-point (``batch_isend_irecv``), packed into one buffer per
  peer.  With the ``gloo`` backend, CUDA tensors are staged through
  pinned host buffers (gloo sends CPU tensors); with ``nccl`` they go
  from the card;
* reductions gather one small tensor per block, in block order, so
  every block sees the same value.

Every block of the mesh must make the same sequence of communication
calls (:meth:`Mesh.transfer`, :meth:`Mesh.allgather_blocks`); loops
whose exit is decided on the host decide it with a reduction
(:func:`cice4_tpu_torch.parallel.halo.global_all`) so that they agree.
Where those loops run inside their kernels (the column physics on the
card) a model step makes no reduction: its only communication is the
neighbour exchanges of :meth:`Mesh.transfer`, each timed as the span
``Exchange`` under the phase that calls it and counted as
``exchanges``; every all-gather counts as ``collectives``
(:mod:`cice4_tpu_torch.timers`).
"""

from __future__ import annotations

import math
import os
import threading

import torch
import torch.distributed as dist

from cice4_tpu_torch import timers


def init_distributed(backend: str | None = None, device="cuda") -> bool:
    """Join the process group behind a flag (port of the JAX package's
    `init_distributed`; the analogue of `init_communicate`,
    ``mpi/ice_communicate.F90:74-141``).

    Set ``CICE4_DISTRIBUTED=1`` with ``CICE4_COORDINATOR=host:port``,
    ``CICE4_NUM_PROCESSES`` and ``CICE4_PROCESS_ID``, or with torchrun's
    ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``.  `backend`
    defaults to ``nccl`` for a CUDA `device` and ``gloo`` for the CPU;
    a backend that fails to initialise raises.  Returns False when the
    flag is not set; safe to call twice.
    """
    env = os.environ
    if not env.get("CICE4_DISTRIBUTED"):
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if env.get("CICE4_COORDINATOR"):
        kw = dict(init_method=f"tcp://{env['CICE4_COORDINATOR']}",
                  world_size=int(env["CICE4_NUM_PROCESSES"]),
                  rank=int(env["CICE4_PROCESS_ID"]))
    elif "RANK" in env and "WORLD_SIZE" in env:
        kw = dict(init_method="env://")
    else:
        raise RuntimeError(
            "CICE4_DISTRIBUTED is set but neither CICE4_COORDINATOR nor "
            "torchrun's RANK/WORLD_SIZE is")
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, **kw)
    return True


def mesh_shape(n: int) -> tuple[int, int]:
    """The near-square (py, px) of `n` blocks (JAX's `make_mesh`, the
    analogue of `proc_decomposition`, ``ice_distribution.F90:228-377``,
    with `processor_shape = 'square-ice'`)."""
    py = int(math.sqrt(n))
    while n % py != 0:
        py -= 1
    return py, n // py


def make_mesh(n_blocks: int | None = None) -> "Mesh":
    """A near-square mesh of `n_blocks` blocks (default: one block per
    process of the group, or one)."""
    if n_blocks is None:
        n_blocks = dist.get_world_size() if _distributed() else 1
    return Mesh(*mesh_shape(n_blocks))


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


class _Ctx:
    """A block's thread: its block, its index among the process's blocks
    and the count of its communication calls (the key that pairs the
    calls of the blocks)."""

    __slots__ = ("mesh", "block", "index", "gen")

    def __init__(self, mesh, block, index):
        self.mesh, self.block, self.index, self.gen = mesh, block, index, 0


class BlockFailed(RuntimeError):
    """Another block of the process failed while this one waited."""


class _Turns:
    """Round-robin turns of a process's block threads.  A thread runs
    only in its turn and passes the turn on at each communication call;
    when the turn comes back every other block has passed the same call,
    so its messages are posted: a barrier without a second thread ever
    running (so the mailbox needs no lock)."""

    def __init__(self, n):
        self.cv = threading.Condition()
        self.n, self.turn = n, 0
        self.done = [False] * n
        self.broken = False

    def wait(self, k):
        with self.cv:
            self.cv.wait_for(lambda: self.turn == k or self.broken)
            if self.broken:
                raise BlockFailed("another block of this process failed")

    def _pass(self, k):
        nxt = (k + 1) % self.n
        while self.done[nxt] and nxt != k:
            nxt = (nxt + 1) % self.n
        self.turn = nxt
        self.cv.notify_all()

    def step(self, k):
        """Pass the turn on and wait for it to come back."""
        with self.cv:
            self._pass(k)
        self.wait(k)

    def finish(self, k):
        with self.cv:
            self.done[k] = True
            self._pass(k)

    def abort(self):
        with self.cv:
            self.broken = True
            self.cv.notify_all()


_tls = threading.local()


def current_block():
    """(mesh, block) of the calling thread inside :meth:`Mesh.run`, or
    None outside it."""
    ctx = getattr(_tls, "ctx", None)
    return None if ctx is None else (ctx.mesh, ctx.block)


class Mesh:
    """A (py, px) mesh of blocks, the blocks owned by the processes of
    the default ``torch.distributed`` group (or all by this process)."""

    def __init__(self, py: int, px: int):
        self.py, self.px = py, px
        self.nblocks = py * px
        self.distributed = _distributed()
        self.nprocs = dist.get_world_size() if self.distributed else 1
        self.rank = dist.get_rank() if self.distributed else 0
        self.backend = dist.get_backend() if self.distributed else None
        if self.nblocks % self.nprocs:
            raise ValueError(f"{self.nblocks} blocks cannot be shared by "
                             f"{self.nprocs} processes")
        self.per_proc = self.nblocks // self.nprocs
        self.local_blocks = tuple(range(self.rank * self.per_proc,
                                        (self.rank + 1) * self.per_proc))
        self._mail: dict = {}
        self._posts: dict = {}
        self._turns = None          # the turns of a run (Mesh.run)

    @property
    def shape(self):
        return (self.py, self.px)

    def __repr__(self):
        return (f"Mesh(py={self.py}, px={self.px}, process {self.rank} of "
                f"{self.nprocs}, blocks {list(self.local_blocks)})")

    # -- layout ----------------------------------------------------------

    def owner(self, block: int) -> int:
        return block // self.per_proc

    def coords(self, block: int) -> tuple[int, int]:
        """(yi, xi) of a block on the mesh."""
        return divmod(block, self.px)

    def block_at(self, yi: int, xi: int) -> int:
        return yi * self.px + xi

    def check_divides(self, ny: int, nx: int):
        if ny % self.py or nx % self.px:
            raise ValueError(f"a {ny}x{nx} grid does not split into "
                             f"{self.py}x{self.px} equal blocks")

    def block_slices(self, block: int, ny: int, nx: int):
        """(rows, columns) of `block` in the global (ny, nx) grid."""
        self.check_divides(ny, nx)
        by, bx = ny // self.py, nx // self.px
        yi, xi = self.coords(block)
        return slice(yi * by, (yi + 1) * by), slice(xi * bx, (xi + 1) * bx)

    def scatter(self, t, block: int):
        """The block's part of a tensor with trailing (ny, nx) axes
        (JAX's `shard_pytree` for one leaf); other values as they are."""
        if not isinstance(t, torch.Tensor) or t.ndim < 2:
            return t
        sy, sx = self.block_slices(block, *t.shape[-2:])
        return t[..., sy, sx].contiguous()

    def assemble(self, parts):
        """The global tensor from every block's part, in block order."""
        rows = [torch.cat(parts[yi * self.px:(yi + 1) * self.px], dim=-1)
                for yi in range(self.py)]
        return torch.cat(rows, dim=-2)

    # -- the block threads -----------------------------------------------

    def run(self, fn):
        """``fn(block)`` for each block this process owns, in lockstep,
        one thread per block (inline for one); returns the results in
        `local_blocks` order.  The mesh is the active one meanwhile.  An
        exception in one block breaks the others' waits and is raised
        here."""
        n = len(self.local_blocks)
        self._mail.clear()
        self._posts.clear()
        self._turns = turns = _Turns(n)
        results = [None] * n
        errors = []
        prev = get_active_mesh()
        set_active_mesh(self)

        def work(k):
            _tls.ctx = _Ctx(self, self.local_blocks[k], k)
            try:
                turns.wait(k)
                results[k] = fn(self.local_blocks[k])
                turns.finish(k)
            except BaseException as e:      # noqa: BLE001 (re-raised below)
                errors.append(e)
                turns.abort()
            finally:
                _tls.ctx = None

        try:
            if n == 1:
                work(0)
            else:
                threads = [threading.Thread(target=work, args=(k,),
                                            name=f"block{b}")
                           for k, b in enumerate(self.local_blocks)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
        finally:
            set_active_mesh(prev)
        if errors:
            real = [e for e in errors if not isinstance(e, BlockFailed)]
            raise (real or errors)[0]
        return results

    def _ctx(self) -> _Ctx:
        ctx = getattr(_tls, "ctx", None)
        if ctx is None or ctx.mesh is not self:
            raise RuntimeError("a mesh communication call outside "
                               "Mesh.run of that mesh")
        ctx.gen += 1
        return ctx

    def _wait(self, ctx):
        """Every block of this process has made the call `ctx` is at
        when this returns."""
        if self.per_proc > 1:
            self._turns.step(ctx.index)

    def _stage(self, t):
        """What goes to torch.distributed: gloo takes CPU tensors, so a
        CUDA tensor is copied to pinned host memory."""
        if self.backend == "gloo" and t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return host
        return t

    def _wire_device(self, device):
        if self.backend == "gloo":
            return torch.device("cpu")
        return device

    # -- communication ---------------------------------------------------

    def transfer(self, sends, recvs, like):
        """Point-to-point messages between blocks.

        `sends`: [(dst_block, tag, tensor)]; `recvs`: [(src_block, tag,
        shape)]; returns the received tensors in `recvs` order.  A message
        is matched by (source, destination, tag); every tensor of a call
        has the dtype and device of `like`.  Every block of the mesh calls
        this together, each with the messages it sends and expects."""
        timers.count("exchanges")
        with timers.span("Exchange"):
            return self._transfer(sends, recvs, like)

    def _transfer(self, sends, recvs, like):
        ctx = self._ctx()
        b, gen = ctx.block, ctx.gen
        remote_out, remote_in = [], []
        dtype, device = like.dtype, like.device
        for dst, tag, t in sends:
            t = t.detach().clone()
            if self.owner(dst) == self.rank:
                self._mail[(gen, b, dst, tag)] = t
            else:
                remote_out.append((b, dst, tag, t))
        for src, tag, shape in recvs:
            if self.owner(src) != self.rank:
                remote_in.append((src, b, tag, tuple(shape)))
        if remote_out or remote_in:
            self._posts.setdefault(gen, []).append(
                (remote_out, remote_in, dtype, device))
        self._wait(ctx)
        # the first block's thread moves the messages between processes
        # before it passes the turn on, so the others find theirs
        if self.nprocs > 1 and b == self.local_blocks[0]:
            self._p2p(gen)
        return [self._mail.pop((gen, src, b, tag))
                for src, tag, _shape in recvs]

    def _p2p(self, gen):
        posts = self._posts.pop(gen, [])
        if not posts:
            return
        dtype, device = posts[0][2:]
        out_by, in_by = {}, {}
        for remote_out, remote_in, _dtype, _device in posts:
            for m in remote_out:
                out_by.setdefault(self.owner(m[1]), []).append(m)
            for m in remote_in:
                in_by.setdefault(self.owner(m[0]), []).append(m)
        key = lambda m: (m[0], m[1], m[2])  # noqa: E731
        ops, recv_bufs = [], []
        for peer in sorted(out_by):
            msgs = sorted(out_by[peer], key=key)
            flat = torch.cat([m[3].reshape(-1) for m in msgs])
            ops.append(dist.P2POp(dist.isend, self._stage(flat), peer))
        for peer in sorted(in_by):
            msgs = sorted(in_by[peer], key=key)
            n = sum(math.prod(m[3]) for m in msgs)
            buf = torch.empty(n, dtype=dtype,
                              device=self._wire_device(device))
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            recv_bufs.append((msgs, buf))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for msgs, buf in recv_bufs:
            buf = buf.to(device)
            off = 0
            for src, dst, tag, shape in msgs:
                n = math.prod(shape)
                self._mail[(gen, src, dst, tag)] = \
                    buf[off:off + n].reshape(shape)
                off += n

    def allgather_blocks(self, t):
        """Every block's `t` (same shape and dtype on each), in block
        order, on every block.  Every block of the mesh calls this
        together."""
        timers.count("collectives")
        ctx = self._ctx()
        b, gen = ctx.block, ctx.gen
        self._mail[(gen, "ag", b)] = t.detach().clone()
        # every block has read the entries of two calls back
        for k in [k for k in self._mail
                  if k[1] == "ag" and k[0] < gen - 1]:
            del self._mail[k]
        self._wait(ctx)
        if self.distributed and b == self.local_blocks[0]:
            local = torch.stack([self._mail[(gen, "ag", lb)]
                                 for lb in self.local_blocks])
            dev = local.device
            wire = self._stage(local)
            parts = [torch.empty_like(wire)
                     for _ in range(self.nprocs)]
            dist.all_gather(parts, wire)
            for p, part in enumerate(parts):
                if p == self.rank:
                    continue
                part = part.to(dev)
                for k in range(self.per_proc):
                    self._mail[(gen, "ag",
                                p * self.per_proc + k)] = part[k]
        return [self._mail[(gen, "ag", k)] for k in range(self.nblocks)]

    def allgather_field(self, t):
        """The global tensor from every block's part `t` (trailing block
        axes), on every block."""
        return self.assemble(self.allgather_blocks(t))


# ---------------------------------------------------------------------------
# active-mesh context
# ---------------------------------------------------------------------------

_ACTIVE_MESH = None


def set_active_mesh(mesh):
    """Register the mesh the model is decomposed over (or None).
    :meth:`Mesh.run` makes its mesh the active one while it runs."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_active_mesh():
    return _ACTIVE_MESH
