"""Particle-mesh parallelism over ``torch.distributed``: one process a device.

Counterpart of ``pocomc_tpu/parallel/mesh.py``. The JAX package shards
the particle axis of one program over a ``jax.sharding.Mesh`` and lets XLA
insert the collectives; here every process drives one device (one rank of
the default process group), holds the rows of every particle-major array
its rank owns, and the collectives are explicit:

- rank r owns rows ``[r n/k, (r+1) n/k)`` of an n-row array over k ranks
  (``P("particles")``'s contiguous blocks);
- flow parameters, the geometry and all host bookkeeping are replicated:
  every process runs the same host loop over the same random streams, and
  draws every random tensor at its full size before it takes its own rows;
- only ``all_reduce`` and ``broadcast`` are used, because the gloo backend
  carries CUDA tensors for those two: a gather of rows is an
  ``all_reduce(SUM)`` of a zero-filled full buffer into which each rank
  wrote its rows (exact: x + 0 = x), and a barrier an ``all_reduce`` of one
  scalar. Objects (blobs of any dtype) go by ``broadcast_object_list``.

The module's helpers (``psum``, ``block``, ``gather_rows``,
``take_rows``, ``map_rows``, ``all_reduce_grads``, ``barrier``) take the mesh as their first argument and are
identities with ``mesh=None``, so the meshless path and the mesh path are
one code path: a one-rank mesh repeats a meshless run bit for bit.

Deliberate differences from the JAX package: one device a process
(``local_device_count`` must be None or 1), and ranks that share a card
talk over gloo (``initialize_distributed`` picks the backend and prints
its choice).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this raises instead of hanging the job
DEFAULT_TIMEOUT_S = 300.0

# this process's device, as initialize_distributed chose it
_LOCAL_DEVICE = None


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_count=None,
                           platform=None):
    """Join this process to a multi-process run: one rank of the default
    ``torch.distributed`` process group, driving one device.

    Parameters
    ----------
    coordinator_address : str or None
        "host:port" of rank 0 (``init_method="tcp://host:port"``). None
        reads the group from the environment (``env://``: ``MASTER_ADDR``,
        ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them).
    num_processes, process_id : int or None
        World size and this process's rank; None reads ``WORLD_SIZE`` /
        ``RANK`` from the environment.
    local_device_count : int or None
        Devices this process drives: None or 1 (one device a process).
    platform : str or None
        "cpu": the gloo backend on the CPU. Otherwise the device is
        ``cuda:{local_rank % torch.cuda.device_count()}``, over NCCL when
        every rank of this host has a card of its own and over gloo, with
        the tensors left on the card, when ranks share one. The choice is
        printed; a failed NCCL init raises.

    Returns
    -------
    (rank, world_size)
    """
    global _LOCAL_DEVICE
    if local_device_count not in (None, 1):
        raise ValueError(
            f"local_device_count={local_device_count!r}: pocomc_tpu_torch drives one device a "
            f"process (torch.distributed's model), so it must be None or 1; the JAX package "
            f"can run one process over several devices, the port cannot.")
    if platform not in (None, "cpu", "cuda", "gpu"):
        raise ValueError(f"Invalid platform {platform!r}. Options are None, 'cpu' or 'cuda'.")
    world = int(os.environ["WORLD_SIZE"] if num_processes is None else num_processes)
    rank = int(os.environ["RANK"] if process_id is None else process_id)
    if platform == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: no CUDA device; pass platform='cpu' "
                               "to run the ranks on the CPU over gloo.")
        n_cards = torch.cuda.device_count()
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
        backend = "nccl" if local_world <= n_cards else "gloo"
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    _LOCAL_DEVICE = device
    print(f"pocomc_tpu_torch: rank {rank}/{world} on {device} over {backend}", flush=True)
    return dist.get_rank(), dist.get_world_size()


def _this_device():
    """The device this process drives: initialize_distributed's choice;
    else the current card under NCCL or with CUDA present, or the CPU."""
    if _LOCAL_DEVICE is not None:
        return _LOCAL_DEVICE
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def same_device(a, b):
    """True if two devices are the same (``cuda`` means the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device() if torch.cuda.is_available() else 0
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


class ParticleMesh:
    """1-D mesh of the process group's ranks, over which particle-major
    arrays are split into contiguous row blocks.

    Parameters
    ----------
    devices : list of torch devices or None
        Every rank's device, in rank order; rank r drives ``devices[r]``.
        None asks every rank for its own (``initialize_distributed``'s
        choice). Without an initialized process group the mesh is one
        process on ``devices[0]`` and every collective is the identity.
    """

    def __init__(self, devices=None):
        self._group = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self._group else 0
        world = dist.get_world_size() if self._group else 1
        if devices is None:
            devices = self._rank_devices(world)
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != world:
            raise ValueError(f"ParticleMesh needs one device a rank: {len(self.devices)} "
                             f"devices for {world} ranks")
        self.device = self.devices[self.rank]
        # diagnostic: how many shard calls fell back to replication because
        # the row count didn't divide the mesh (as the JAX package counts)
        self.replication_fallbacks = 0

    def _rank_devices(self, world):
        here = _this_device()
        if not self._group:
            return [here]
        code = torch.zeros(world, dtype=torch.int64, device=here)
        code[self.rank] = -1 if here.type == "cpu" else here.index + 1
        dist.all_reduce(code)
        return [torch.device("cpu") if c < 0 else torch.device("cuda", c - 1)
                for c in code.tolist()]

    @property
    def size(self):
        return len(self.devices)

    @property
    def multihost(self):
        """True when the mesh spans more than one process."""
        return self.size > 1

    def _tensor(self, arr):
        if torch.is_tensor(arr):
            return arr.to(self.device)
        return torch.as_tensor(np.asarray(arr), device=self.device)

    def _split(self, arr, axis):
        """This rank's block of ``arr`` along ``axis``; the whole array,
        counted as a replication fallback, when the mesh does not divide
        the axis."""
        t = self._tensor(arr)
        n = t.shape[axis]
        if n % self.size != 0:
            self.replication_fallbacks += 1
            return t
        m = n // self.size
        return t.narrow(axis, self.rank * m, m)

    def shard_particles(self, arr):
        """This rank's rows of a particle-major array (first axis =
        particles), as a tensor on this rank's device. A row count the mesh
        does not divide falls back to the whole array (replication) and
        is counted in ``replication_fallbacks``."""
        return self._split(arr, 0)

    def shard_history(self, hist_tree):
        """Slot-major (T_max, n[, d]) history buffers with the particle
        axis (axis 1) split into this rank's rows, and the per-slot
        scalars replicated, for dicts, lists and tuples of arrays."""
        return tree_map(lambda a: (self._split(a, 1) if np.ndim(a) >= 2
                                   else self._tensor(a)), hist_tree)

    def shard_batches(self, arr):
        """This rank's rows of every batch of a (n_batches, batch, ...)
        stack (the batch axis split; an indivisible batch falls back to
        replication and is counted)."""
        return self._split(arr, 1)

    def replicate(self, tree):
        """Every tensor (or numpy array) of a tree on this rank's device,
        broadcast from rank 0, so every rank holds rank 0's bits (as
        contiguous copies: NCCL sends no other)."""
        def bcast(a):
            t = self._tensor(a).clone(memory_format=torch.contiguous_format)
            if self._group:
                dist.broadcast(t, src=0)
            return t
        return tree_map(bcast, tree)

    def gather(self, garr):
        """Full host copy, on every rank, of an array split as
        ``shard_particles`` splits it: every rank's rows in rank order
        (the reverse of shard_particles), as numpy."""
        return gather_rows(self, self._tensor(garr)).cpu().numpy()

    def shard_callback(self, loglike, n_out_per_row: int = 1):
        """Per-rank fan-out of a ``loglike(x, mask) -> logl`` on full,
        replicated rows: the wrapped callable takes the full (x, mask),
        calls ``loglike`` on this rank's rows only and returns the full
        result, gathered. ``n_out_per_row`` is the JAX package's and is
        not needed: the result's trailing shape is ``loglike``'s."""
        def sharded(x, mask):
            return gather_rows(self, loglike(block(self, x), block(self, mask)))
        return sharded

    def pad_to_multiple(self, n: int) -> int:
        """Smallest multiple of the mesh size >= n."""
        k = self.size
        return ((n + k - 1) // k) * k

    def _all_reduce(self, t, op=None):
        if self._group:
            dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op)
        return t


def tree_map(fn, tree):
    """``fn`` on every tensor or numpy array of nested dicts, lists and
    tuples (NamedTuples kept); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)._make(tree_map(fn, v) for v in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return fn(tree)
    return tree


# -- collectives: identities with mesh=None ---------------------------------

def psum(mesh, *tensors):
    """Each tensor summed over the ranks, all in one ``all_reduce`` (packed
    in float64, which holds float32 values and int64 counts exactly, and
    cast back). The tensors themselves with ``mesh=None``."""
    if mesh is None:
        return tensors if len(tensors) > 1 else tensors[0]
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    mesh._all_reduce(flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return tuple(out) if len(out) > 1 else out[0]


def block(mesh, full):
    """This rank's rows of a replicated particle-major tensor (or numpy
    array); the whole of it with ``mesh=None``."""
    if mesh is None:
        return full
    m = full.shape[0] // mesh.size
    return full[mesh.rank * m:(mesh.rank + 1) * m]


def gather_rows(mesh, local):
    """Every rank's rows in rank order, on every rank: an ``all_reduce`` of
    a zero-filled buffer in which each rank wrote its own. The tensor
    itself with ``mesh=None``."""
    if mesh is None:
        return local
    m = local.shape[0]
    wire = torch.uint8 if local.dtype == torch.bool else local.dtype
    buf = torch.zeros((m * mesh.size,) + tuple(local.shape[1:]), dtype=wire,
                      device=local.device)
    buf[mesh.rank * m:(mesh.rank + 1) * m] = local
    return mesh._all_reduce(buf).to(local.dtype)


def take_rows(mesh, local, idx, n):
    """Rows ``idx`` (flat indices into T_max * n) of a slot-major (T_max, n,
    ...) history array whose particle axis is split over the ranks (this
    rank holds ``local``, (T_max, n/k, ...)), on every rank: each rank
    writes the rows it owns into a zero buffer, then one ``all_reduce``."""
    if mesh is None:
        return local.reshape(local.shape[0] * n, *local.shape[2:])[idx]
    m = local.shape[1]
    t, j = idx // n, idx % n
    mine = (j // m) == mesh.rank
    buf = torch.zeros((idx.shape[0],) + tuple(local.shape[2:]), dtype=local.dtype,
                      device=local.device)
    buf[mine] = local[t[mine], j[mine] - mesh.rank * m]
    return mesh._all_reduce(buf)


def map_rows(mesh, fn, full):
    """``fn`` on this rank's rows of the replicated ``full``, the ranks'
    results gathered: ``fn(full)`` with ``mesh=None`` or one rank, and on
    every rank, as a counted replication fallback, when the mesh does not
    divide the rows. ``fn`` returns a tensor or a tuple of tensors."""
    if mesh is None:
        return fn(full)
    part = mesh.shard_particles(full)
    out = fn(part)
    if part.shape[0] == full.shape[0]:
        return out
    if isinstance(out, tuple):
        return tuple(gather_rows(mesh, o) for o in out)
    return gather_rows(mesh, out)


def all_reduce_grads(mesh, params):
    """Sum every parameter's gradient over the ranks, as one flat float32
    buffer in one ``all_reduce``."""
    if mesh is None:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh._all_reduce(flat)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


def broadcast_seed(mesh, seed):
    """Rank 0's ``seed`` on every rank (an unseeded run must follow one
    random stream everywhere)."""
    if mesh is None or not mesh.multihost:
        return seed
    t = torch.tensor([int(seed)], dtype=torch.int64, device=mesh.device)
    dist.broadcast(t, src=0)
    return int(t.item())


def barrier(mesh):
    """Wait for every rank (an ``all_reduce`` of one scalar)."""
    if mesh is not None:
        mesh._all_reduce(torch.zeros(1, device=mesh.device))


def gather_objects(mesh, local):
    """Every rank's numpy array of objects (blobs of any dtype) joined in
    rank order, by one ``broadcast_object_list`` a rank; the array itself
    with ``mesh=None``."""
    if mesh is None or not mesh._group:
        return local
    parts = []
    for r in range(mesh.size):
        box = [local if r == mesh.rank else None]
        dist.broadcast_object_list(box, src=r)
        parts.append(box[0])
    return np.concatenate(parts)
