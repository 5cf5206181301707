"""Seed sweeps split over worker processes, one per device.

PyTorch counterpart of ``diffsdfsim_tpu/parallel/sharding.py``, with the
same three names. The JAX package vmaps a per-seed rollout and shards the
seed axis over a 1-D device mesh: one SPMD program, whose whole-batch gates
XLA turns into collectives. The port differs in two ways.

- ``fn`` is batched, not per-seed: it maps inputs with a leading lane axis
  to outputs with a leading lane axis. The port's counterpart of
  ``jax.vmap`` over a rollout is the batched-native rollout
  (``physics/batched.py``: ``make_world_batched``, ``rollout_batched``).
  ``torch.func.vmap`` cannot map a rollout, because its control flow is host
  reads (``WorldSpec.host_bool``).
- A device of the mesh is a worker process. Each path of the port is bound
  by the host's eager dispatch (the card idles most of a rollout's wall), so
  one Python process cannot keep several cards busy. Each worker runs ``fn``
  on its contiguous chunk of lanes on its own device and decides the
  batch's gates over its chunk alone: no collective is needed, since a lane
  steps as it would alone. On the CPU a lane's result is bitwise the same
  whatever the number of workers; on the card, batched operations over
  another batch size may round apart in the last bits.

A gradient is taken inside ``fn`` (``torch.autograd.grad`` and whatever
update follows it): no tape crosses a process. Chunks go to the workers and
results come back as CPU tensors, pickled (no CUDA IPC, no NCCL: several
workers may share one card). The workers start once per mesh and serve every
call until ``Mesh.close``. Each process has its own kernel launch counters
(``launch_counts``), so each call reports them per worker
(``BatchedRollout.stats``).
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import pickle
import sys
import threading
import time
import traceback

import torch

from ..config import resolve_device


def launch_counts() -> dict:
    """The launches each hand-written kernel's wrapper has counted in this
    process, by kernel."""
    from ..ops.fw_cuda import fw_search_pair
    from ..ops.grid_cuda import grid_interp, grid_query_kernel, grid_query_lanes_kernel
    from ..ops.igr_cuda import igr_mlp
    from ..ops.qp_cuda import kkt_grad_fric, pdipm_fric

    return {"pdipm_fwd": pdipm_fric.launches, "fw_search": fw_search_pair.launches,
            "kkt_bwd": kkt_grad_fric.launches, "igr_mlp": igr_mlp.launches, "grid_query": grid_query_kernel.launches,
            "grid_query_lanes": grid_query_lanes_kernel.launches, "grid_interp": grid_interp.launches}


def _tree_map(f, *trees):
    """f over the leaves of trees of one structure: nested tuples (named
    ones too), lists and dicts; any other object is a leaf."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(f, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        if any(len(t) != len(t0) for t in trees):
            raise ValueError("the trees differ in structure")
        out = [_tree_map(f, *xs) for xs in zip(*trees)]
        return type(t0)(*out) if hasattr(t0, "_fields") else type(t0)(out)
    return f(*trees)


def _tensor_leaves(tree) -> list:
    out = []
    _tree_map(lambda x: out.append(x) if isinstance(x, torch.Tensor) else None, tree)
    return out


def _to_cpu(x):
    """A detached CPU copy of a tensor with storage of its own (pickling a
    view would send its whole storage)."""
    return x.detach().to("cpu", copy=True)


def _run_fn(fn, batch, has_aux, device):
    """fn(batch) with the batch's tensors on ``device``, synchronized there;
    returns (outputs, aux, seconds, launches made)."""
    batch = _tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, batch)
    before = launch_counts()
    t0 = time.perf_counter()
    res = fn(batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    after = launch_counts()
    out, aux = res if has_aux else (res, None)
    return out, aux, seconds, {k: after[k] - before[k] for k in after}


def _exit_with_parent(ppid):
    """Stop this worker when the process that started it is gone (a parent
    killed outright runs no clean-up of its own)."""
    while True:
        time.sleep(1.0)
        if os.getppid() != ppid:
            os._exit(1)


def _worker(conn, device, threads, ppid):
    """A worker's loop: pin the device, then run (fn, chunk, has_aux) messages
    until an empty message or the end of the pipe. Replies are ("ok",
    (outputs on the CPU, aux, seconds, launches)) or ("error", traceback)."""
    threading.Thread(target=_exit_with_parent, args=(ppid,), daemon=True).start()
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.zeros((), device=dev)  # create the context before reporting ready
        torch.set_num_threads(threads)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        conn.send_bytes(pickle.dumps(("ok", None)))
    except Exception:
        conn.send_bytes(pickle.dumps(("error", traceback.format_exc())))
        return
    while True:
        try:
            msg = conn.recv_bytes()
        except EOFError:
            msg = b""
        if not msg:
            # nothing of the worker's needs a clean-up: skip the interpreter's (~1 s with torch)
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(0)
        try:
            fn, chunk, has_aux = pickle.loads(msg)
            out, aux, seconds, launches = _run_fn(fn, chunk, has_aux, dev)
            reply = ("ok", (_tree_map(_to_cpu, out), aux, seconds, launches))
        except Exception:
            reply = ("error", traceback.format_exc())
        conn.send_bytes(pickle.dumps(reply))


class WorkerError(RuntimeError):
    """A worker raised, died or could not start; the message holds its
    traceback or exit code."""


class Mesh:
    """The port's device mesh: an ordered list of devices, one worker
    process each (``make_mesh``). A card listed more than once has several
    workers, which share it. Each worker pins its device, leaves TF32 off
    and takes an equal share of the caller's intra-op threads
    (``torch.get_num_threads() // len(devices)``, at least 1). Close the
    mesh (or use it as a context manager) to stop the workers."""

    def __init__(self, devices):
        self.devices = tuple(devices)
        ctx = multiprocessing.get_context("spawn")
        # the caller's intra-op threads, shared out: more would oversubscribe
        # the host's cores, which the caller's own budget already divides
        threads = max(1, torch.get_num_threads() // len(self.devices))
        self._procs, self._conns = [], []
        t0 = time.perf_counter()
        try:
            for dev in self.devices:
                ours, theirs = ctx.Pipe()
                p = ctx.Process(target=_worker, args=(theirs, str(dev), threads, os.getpid()), daemon=True,
                                name=f"diffsdfsim-worker-{dev}")
                p.start()
                theirs.close()
                self._procs.append(p)
                self._conns.append(ours)
            self._gather()
        except BaseException:
            self.close()
            raise
        self.start_seconds = time.perf_counter() - t0  # the pool's start wall

    def __len__(self):
        return len(self.devices)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _gather(self):
        """Every worker's reply to the last message, in worker order; raises
        WorkerError (after every reply is in) if one failed. A worker that
        died takes the mesh down with it."""
        replies, pending = [None] * len(self), set(range(len(self)))
        while pending:
            waits = [self._conns[i] for i in pending] + [self._procs[i].sentinel for i in pending]
            multiprocessing.connection.wait(waits)
            for i in sorted(pending):
                conn, proc = self._conns[i], self._procs[i]
                alive = proc.is_alive()  # before the poll: a dead worker's reply is in the pipe by then
                try:
                    if conn.poll():
                        replies[i] = pickle.loads(conn.recv_bytes())
                    elif alive:
                        continue
                    else:
                        raise EOFError
                except EOFError:
                    proc.join()
                    replies[i] = ("died", f"worker {i} on {self.devices[i]} exited with code {proc.exitcode}")
                pending.discard(i)
        failed = [(i, r) for i, r in enumerate(replies) if r[0] != "ok"]
        if any(r[0] == "died" for _, r in failed):
            self.close()
        if failed:
            i, (_, text) = failed[0]
            more = f" (and workers {[j for j, _ in failed[1:]]})" if len(failed) > 1 else ""
            raise WorkerError(f"worker {i} on {self.devices[i]} failed{more}:\n{text}")
        return [r[1] for r in replies]

    def run(self, fn, chunks, has_aux=False):
        """fn(chunks[i]) in worker i, all at once; returns each worker's
        (outputs on the CPU, aux, seconds, launches)."""
        if not self._procs:
            raise RuntimeError("the mesh is closed")
        if len(chunks) != len(self):
            raise ValueError(f"{len(chunks)} chunks for a mesh of {len(self)} workers")
        msgs = [pickle.dumps((fn, chunk, has_aux)) for chunk in chunks]  # all or none are sent
        for conn, msg in zip(self._conns, msgs):
            conn.send_bytes(msg)
        return self._gather()

    def close(self):
        """Stop every worker (idempotent)."""
        for conn in self._conns:
            try:
                conn.send_bytes(b"")
            except OSError:
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """The port's mesh: one worker process per entry of ``devices``, in
    order. The default is every visible CUDA device, or the first
    ``n_devices`` of them; without a card it raises, unless the caller names
    CPU devices (``devices=["cpu", "cpu"]``, as the tests do). A card may be
    listed more than once (``["cuda:0"] * 4``): its workers share it. The
    hand-written kernels are built here before the workers start, so each
    worker only loads them."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; name CPU devices (devices=['cpu', 'cpu']) "
                               "to run the plain PyTorch path in CPU workers")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if not 0 < n_devices <= len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked of {len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no device")
    cuda = [d for d in devices if d.type == "cuda"]
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh: {cuda[0]} named, but no CUDA device is available")
        devices = [torch.device("cuda", d.index or 0) if d.type == "cuda" else d for d in devices]
        bad = [d for d in devices if d.type == "cuda" and d.index >= torch.cuda.device_count()]
        if bad:
            raise ValueError(f"make_mesh: {bad[0]} named, {torch.cuda.device_count()} CUDA devices visible")
        from ..ops import _build

        _build.build_all(_build.KERNELS)
    return Mesh(devices)


class Sharded:
    """A batch split over a mesh: worker i takes ``chunks[i]``, the batch's
    lanes ``lanes[i]`` (a range) of every tensor leaf as CPU tensors."""

    def __init__(self, mesh: Mesh, chunks: list, lanes: list):
        self.mesh, self.chunks, self.lanes = mesh, chunks, lanes


def shard_batch(tree, mesh: Mesh) -> Sharded:
    """Split the leading (lane) axis of every tensor leaf of ``tree`` into
    ``len(mesh)`` equal, contiguous chunks in lane order, one per worker
    (other leaves go whole to every worker). A lane count that the mesh
    does not divide raises, as JAX's ``NamedSharding`` does."""
    leaves = _tensor_leaves(tree)
    if not leaves:
        raise ValueError("shard_batch: the batch holds no tensor")
    n = leaves[0].shape[0] if leaves[0].dim() else 0
    if any(x.dim() == 0 or x.shape[0] != n for x in leaves):
        raise ValueError(f"shard_batch: the tensors' leading axes differ: {[tuple(x.shape) for x in leaves]}")
    if n == 0 or n % len(mesh):
        raise ValueError(f"shard_batch: {n} lanes do not split evenly over a mesh of {len(mesh)} devices")
    per = n // len(mesh)
    lanes = [range(i * per, (i + 1) * per) for i in range(len(mesh))]
    chunks = [_tree_map(lambda x, r=r: _to_cpu(x[r.start:r.stop]) if isinstance(x, torch.Tensor) else x, tree)
              for r in lanes]
    return Sharded(mesh, chunks, lanes)


class BatchedRollout:
    """``batched_rollout``'s step: ``step(batch)`` runs ``fn`` over the lanes
    of ``batch`` (a tree of tensors with a leading lane axis, or its
    ``shard_batch``) and returns fn's outputs, detached, concatenated in lane
    order on ``device`` (with ``has_aux``: ``(outputs, [aux of each
    chunk])``). After each call ``stats`` holds one dict per chunk: its
    device, its lanes, the seconds fn took there (synchronized) and the
    kernel launches it made."""

    def __init__(self, fn, mesh: Mesh | None, device, has_aux: bool):
        self.fn, self.mesh, self.has_aux = fn, mesh, has_aux
        self.device = resolve_device(device)
        self.stats = []

    def __call__(self, batch):
        if self.mesh is None:
            if isinstance(batch, Sharded):
                raise ValueError("a sharded batch for a step without a mesh")
            n = _tensor_leaves(batch)[0].shape[0]
            out, aux, seconds, launches = _run_fn(self.fn, batch, self.has_aux, self.device)
            out = _tree_map(lambda x: x.detach(), out)
            self.stats = [dict(device=str(self.device), lanes=range(n), seconds=seconds, launches=launches)]
            return (out, [aux]) if self.has_aux else out
        sharded = batch if isinstance(batch, Sharded) else shard_batch(batch, self.mesh)
        if sharded.mesh is not self.mesh:
            raise ValueError("the batch is sharded over another mesh")
        replies = self.mesh.run(self.fn, sharded.chunks, self.has_aux)
        for i, (out, _, _, _) in enumerate(replies):
            for x in _tensor_leaves(out):
                if x.dim() == 0 or x.shape[0] != len(sharded.lanes[i]):
                    raise ValueError(f"worker {i}'s output {tuple(x.shape)} has no leading axis of its "
                                     f"{len(sharded.lanes[i])} lanes")
        out = _tree_map(lambda *xs: torch.cat(xs).to(self.device), *(r[0] for r in replies))
        self.stats = [dict(device=str(d), lanes=r, seconds=rep[2], launches=rep[3])
                      for d, r, rep in zip(self.mesh.devices, sharded.lanes, replies)]
        return (out, [r[1] for r in replies]) if self.has_aux else out


def batched_rollout(fn, mesh: Mesh | None = None, device=None, has_aux: bool = False) -> BatchedRollout:
    """Lift a batched rollout/loss function over a mesh.

    ``fn(batch) -> outputs`` maps a tree of tensors with a leading lane axis
    to a tree of tensors with a leading lane axis (with ``has_aux``: to
    ``(outputs, aux)``, aux any picklable object, reported per chunk). It is
    batched, not per-seed: see the module's docstring. With ``mesh=None``
    fn runs in the caller on ``device``; with a mesh each worker runs it on
    its chunk on its own device. ``device`` is also where the outputs are
    gathered; ``None`` means CUDA (raises without a card). A gradient is
    taken inside fn. A worker's exception, death or failure to start raises
    ``WorkerError`` in the caller, with the worker's traceback; its chunk is
    not run again here."""
    return BatchedRollout(fn, mesh, device, has_aux)
