"""
Several processes as one mesh (PyTorch port of
:mod:`tpu_assim.parallel.multihost`), on ``torch.distributed``.

Every process runs the same program: it calls :func:`initialize_multihost`
once, builds the same global mesh with :func:`global_grid_mesh` (each
position knows the rank of the process that holds it), and runs the same
analysis, which computes the shards of its own positions and exchanges
blocks with the other processes point to point. There is no scheduler.

    from tpu_assim_torch.parallel.multihost import (
        initialize_multihost, global_grid_mesh, host_local_to_global)

    initialize_multihost()                     # torchrun's env:// variables
    mesh = global_grid_mesh()                  # each process's own card
    state = host_local_to_global(mesh, local_state_block)   # [k, g_global]
    analyse = halo_letkf_analysis(mesh, loc, ...)           # parallel/halo.py
    analysis = analyse(state, *sharded_obs)    # this process's blocks
    shutdown_multihost()                       # on every process, at the end

Launch it with ``torchrun --nproc-per-node N script.py``, or start the
processes yourself and name the group:
``initialize_multihost("tcp://localhost:29500", N, rank)``.

A mesh may name one card several times (virtual shards), also across
processes: two processes that share one card run over gloo, which stages
CUDA blocks through host memory; processes with a card each run over
NCCL.
"""

import datetime
import os
import socket
from typing import Optional
from urllib.parse import urlparse

import numpy as np
import torch
import torch.distributed as dist

from tpu_assim_torch.parallel.mesh import GRID_AXIS, Mesh

__all__ = [
    "GlobalTensor",
    "all_blocks",
    "exchange_blocks",
    "global_grid_mesh",
    "host_local_to_global",
    "initialize_multihost",
    "max_across_processes",
    "process_count",
    "process_hosts",
    "process_index",
    "process_info",
    "resplit",
    "shutdown_multihost",
]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if _initialized() else 1


def _local_host(address: str) -> bool:
    host = urlparse(address if "://" in address else f"tcp://{address}")
    return host.hostname in ("localhost", "127.0.0.1", "::1")


def _processes_on_host(address: Optional[str], world: int) -> int:
    """How many of the group's processes share this host: torchrun's
    ``LOCAL_WORLD_SIZE``, else all of them on a local address, else one."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None:
        return int(local)
    return world if address is None or _local_host(address) else 1


def _own_card(rank: int) -> int:
    """The card of a process that shares its host: its local rank
    (torchrun's ``LOCAL_RANK``, else its rank) modulo the visible cards."""
    return int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    timeout: Optional[float] = None,
) -> None:
    """One-time ``torch.distributed`` handshake.

    With no arguments it reads the ``env://`` variables that ``torchrun``
    sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    ``coordinator_address`` (``"tcp://host:port"`` or ``"host:port"``),
    ``num_processes`` and ``process_id`` name the group by hand; a named
    address starts a group even of one process. A no-op when a group
    exists, or when nothing names more than one process.

    The backend is ``"nccl"`` when this host has a card for each of its
    processes, else ``"gloo"``. ``timeout``: seconds a collective or a
    transfer waits before it fails (default torch's).
    """
    if _initialized():
        return
    world = num_processes
    if world is None and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
    if coordinator_address is None and (world is None or world <= 1):
        return
    if world is None:
        raise ValueError("a coordinator address needs num_processes (or "
                         "WORLD_SIZE)")
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", 0)))
    init = "env://"
    if coordinator_address is not None:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    backend = "gloo"
    if torch.cuda.is_available():
        local = _processes_on_host(coordinator_address, world)
        if torch.cuda.device_count() >= local:
            backend = "nccl"
            torch.cuda.set_device(_own_card(rank))
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, **kwargs)


def shutdown_multihost() -> None:
    """The end of a run of several processes, on every process (the
    counterpart of ``jax.distributed.shutdown``): K8's exchange buffers
    unmapped and freed
    (:func:`tpu_assim_torch.parallel.cuda_halo.release_exchanges`), a
    barrier, and the process group destroyed. A process that exits with
    its group alive may abort in the group's teardown (std::terminate)
    while another process still talks to it. A no-op without a group."""
    if not _initialized():
        return
    from tpu_assim_torch.parallel.cuda_halo import release_exchanges

    release_exchanges()
    dist.barrier()
    dist.destroy_process_group()


def _comm_device() -> torch.device:
    """Where this process's collectives take their tensors."""
    if _initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _local_devices(devices=None):
    """This process's devices: ``devices``; by default its own card in a
    group of several processes under NCCL or as torchrun's
    ``LOCAL_WORLD_SIZE`` > 1 says (torchrun does not narrow the visible
    cards), else every card it sees."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a process contributes the CUDA devices it sees by default, and "
            "this one sees none; pass devices (e.g. devices=['cpu'] * 4)")
    if process_count() > 1 and (dist.get_backend() == "nccl" or int(
            os.environ.get("LOCAL_WORLD_SIZE", 1)) > 1):
        return [torch.device("cuda", _own_card(process_index()))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def process_info(devices=None) -> dict:
    """Process topology for logging: ``process_index``, ``process_count``,
    ``local_devices`` (this process's, by default as
    :func:`global_grid_mesh` takes them) and ``global_devices`` (their sum
    over the processes)."""
    n_local = len(_local_devices(devices))
    n_global = n_local
    if _initialized():
        t = torch.tensor([n_local], dtype=torch.int64, device=_comm_device())
        dist.all_reduce(t)
        n_global = int(t.item())
    return {"process_index": process_index(),
            "process_count": process_count(),
            "local_devices": n_local,
            "global_devices": n_global}


def process_hosts() -> list:
    """Each process's host name, by rank: a collective over every process
    (this host's name alone without a group)."""
    name = socket.gethostname()
    if process_count() == 1:
        return [name]
    names = [None] * process_count()
    dist.all_gather_object(names, name)
    return names


def global_grid_mesh(devices=None, axis_name: str = GRID_AXIS) -> Mesh:
    """1-D mesh over every process's devices, in rank order (by default
    a process's own card when processes share a host, as under
    ``torchrun --nproc-per-node N``, else every CUDA device it sees;
    ``devices=["cpu"] * 4`` in a test).
    Each position knows its owner rank; every process builds the same
    mesh. With one process it is :func:`make_grid_mesh`'s mesh."""
    local = [str(d) for d in _local_devices(devices)]
    lists = [local]
    if process_count() > 1:
        lists = [None] * process_count()
        dist.all_gather_object(lists, local)
    flat = [d for part in lists for d in part]
    owners = [r for r, part in enumerate(lists) for _ in part]
    return Mesh(flat, (axis_name,), owners=owners if len(lists) > 1 else None)


def max_across_processes(values: np.ndarray) -> np.ndarray:
    """The elementwise maximum of a float array over every process (the
    array itself without a group). Filled with ``-inf`` where a process
    holds nothing, it assembles the parts each process owns."""
    values = np.asarray(values, dtype=np.float64)
    if process_count() == 1:
        return values
    t = torch.as_tensor(values, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.cpu().numpy()


# -- point-to-point blocks ----------------------------------------------------

def _transfer(pairs, blocks, owners, template):
    """The cross-process transfers of ``pairs`` ((source shard, destination
    rank), one order on every process) by one batch of ``isend``/``irecv``:
    this process sends the blocks it holds and receives the ones sent to
    it. Under gloo a CUDA block is staged through host memory. Returns the
    received blocks by source shard."""
    rank = process_index()
    stage = dist.get_backend() != "nccl"
    ops, received = [], {}
    for tag, (src, dst) in enumerate(pairs):
        if owners[src] == rank:
            block = blocks[src].contiguous()
            ops.append(dist.P2POp(dist.isend, block.cpu() if stage else block,
                                  dst, tag=tag))
        elif dst == rank:
            buf = torch.empty(template.shape, dtype=template.dtype,
                              device="cpu" if stage else template.device)
            received[src] = buf
            ops.append(dist.P2POp(dist.irecv, buf, owners[src], tag=tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return received


def _template(blocks):
    """A block this process holds (the shape and dtype of every block)."""
    return next((b for b in blocks if b is not None), None)


def exchange_blocks(blocks, sources, owners=None):
    """Each shard receives the blocks of its source shards, on its device.

    Parameters
    ----------
    blocks : one entry per shard, in shard order: the tensor of each shard
        this process holds (all of one shape and dtype), None for a shard
        of another process.
    sources : per shard, the shard indices it receives, the same list on
        every process.
    owners : per shard, the rank of the process that holds it; None: this
        process holds every shard.

    Returns per shard the list of its sources' blocks on its device (None
    for a shard of another process). A source of this process is copied
    with ``.to(device)`` (no copy on the same device); one of another
    process arrives by ``torch.distributed`` point-to-point transfers, once
    for each receiving process. The blocks are the sources bit for bit.
    """
    n = len(blocks)
    received = {}
    if owners is not None and len(set(owners)) > 1:
        pairs = sorted({(src, owners[s]) for s in range(n)
                        for src in sources[s] if owners[src] != owners[s]})
        received = _transfer(pairs, blocks, owners, _template(blocks))
    out = []
    for s in range(n):
        if blocks[s] is None:
            out.append(None)
            continue
        device = blocks[s].device
        out.append([(blocks[src] if blocks[src] is not None
                     else received[src]).to(device) for src in sources[s]])
    return out


def all_blocks(blocks, owners, device):
    """Every shard's block on ``device``, on every process: the blocks of
    ``owners``' shards (None where another process holds one; each
    process holds at least one), each process sending its own to every
    other."""
    n = len(blocks)
    if owners is not None and len(set(owners)) > 1:
        ranks = sorted(set(owners))
        pairs = [(src, r) for src in range(n) for r in ranks
                 if r != owners[src]]
        received = _transfer(pairs, blocks, owners, _template(blocks))
        blocks = [b if b is not None else received[s]
                  for s, b in enumerate(blocks)]
    return [b.to(device) for b in blocks]


# -- arrays split over processes ----------------------------------------------

def _as_axes(axis, axis_name):
    dims = (axis,) if isinstance(axis, int) else tuple(axis)
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if len(dims) != len(names):
        raise ValueError(f"{len(dims)} tensor dims for {len(names)} mesh "
                         "axis names")
    return dims, tuple((a,) if isinstance(a, str) else tuple(a)
                       for a in names)


def _position(mesh: Mesh, axes, key):
    """The mesh position of the shard ``key`` of a split over ``axes``."""
    pos = [0] * mesh.devices.ndim
    for names, index in zip(axes, key):
        extents = [mesh.shape[a] for a in names]
        for name, i in zip(names, np.unravel_index(index, extents)):
            pos[mesh.axis_names.index(name)] = int(i)
    return tuple(pos)


def _owner(mesh: Mesh, axes, key) -> int:
    if mesh.owners is None:
        return process_index()
    return int(mesh.owners[_position(mesh, axes, key)])


class GlobalTensor:
    """A tensor split over a mesh's positions, across processes: this
    process's blocks on their devices, with the global shape (the
    counterpart of a ``jax.Array`` made by
    ``jax.make_array_from_process_local_data``).

    Tensor dim ``dims[i]`` splits evenly over the mesh axes ``axes[i]``
    (several axes flatten row-major into one split, as a
    ``PartitionSpec(("row", "col"))``); every other mesh axis replicates.
    A shard's key is its tuple of split indices, one per split dim;
    ``blocks`` maps the keys of this process's shards to their blocks.
    """

    def __init__(self, mesh: Mesh, shape, dims, axes, blocks: dict):
        self.mesh = mesh
        self.shape = torch.Size(shape)
        self.dims = tuple(d % len(self.shape) for d in dims)
        self.axes = tuple(axes)
        self.blocks = dict(blocks)
        self.splits = tuple(int(np.prod([mesh.shape[a] for a in names]))
                            for names in self.axes)
        for d, n in zip(self.dims, self.splits):
            if self.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(self.shape)} does not "
                                 f"split evenly over {n} shards")

    @property
    def dtype(self):
        return next(iter(self.blocks.values())).dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def block_shape(self):
        shape = list(self.shape)
        for d, n in zip(self.dims, self.splits):
            shape[d] //= n
        return tuple(shape)

    def keys(self):
        """Every shard's key, in row-major order."""
        return [tuple(k) for k in np.ndindex(*self.splits)]

    def position(self, key):
        """The mesh position (index tuple) of a shard."""
        return _position(self.mesh, self.axes, key)

    def owner(self, key) -> int:
        return _owner(self.mesh, self.axes, key)

    def device(self, key) -> torch.device:
        return self.mesh.devices[self.position(key)]

    def slices(self, key):
        """The global index of a shard's block."""
        index = [slice(None)] * self.ndim
        shape = self.block_shape()
        for d, i in zip(self.dims, key):
            index[d] = slice(i * shape[d], (i + 1) * shape[d])
        return tuple(index)

    def matches(self, dims, axes) -> bool:
        dims = tuple(d % self.ndim for d in dims)
        return dims == self.dims and tuple(axes) == self.axes

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the device of this
        process's first block), on every process: a collective."""
        keys = self.keys()
        if device is None:
            device = next(iter(self.blocks.values())).device
        owners = [self.owner(k) for k in keys]
        blocks = all_blocks([self.blocks.get(k) for k in keys], owners,
                            device)
        out = torch.empty(self.shape, dtype=blocks[0].dtype, device=device)
        for key, block in zip(keys, blocks):
            out[self.slices(key)] = block
        return out

    def __repr__(self):
        return (f"GlobalTensor(shape={tuple(self.shape)}, dims={self.dims}, "
                f"axes={self.axes}, local keys={sorted(self.blocks)})")


def host_local_to_global(mesh: Mesh, local_block, axis=-1,
                         axis_name=GRID_AXIS) -> GlobalTensor:
    """Assemble a :class:`GlobalTensor` from each process's local block,
    without gathering (the counterpart of
    ``jax.make_array_from_process_local_data``).

    ``axis`` (an int, or a tuple of them) names the split tensor dims and
    ``axis_name`` the mesh axis (or tuple of axes) each splits over.
    ``local_block`` is the part of the global tensor that this process's
    positions hold: along each split dim, its shards must form one
    contiguous run. Each shard's block goes to its position's device.
    """
    local_block = torch.as_tensor(local_block)
    dims, axes = _as_axes(axis, axis_name)
    dims = tuple(d % local_block.ndim for d in dims)
    splits = tuple(int(np.prod([mesh.shape[a] for a in names]))
                   for names in axes)
    rank = process_index()
    mine = [tuple(k) for k in np.ndindex(*splits)
            if _owner(mesh, axes, k) == rank]
    if not mine:
        raise ValueError(f"process {rank} holds no position of the mesh")
    lo = [min(k[i] for k in mine) for i in range(len(dims))]
    hi = [max(k[i] for k in mine) + 1 for i in range(len(dims))]
    if len(mine) != int(np.prod([h - l for l, h in zip(lo, hi)])):
        raise ValueError("this process's positions do not form one "
                         "contiguous block of the split dims")
    shape = list(local_block.shape)
    block = list(local_block.shape)
    for i, d in enumerate(dims):
        count = hi[i] - lo[i]
        if shape[d] % count:
            raise ValueError(f"a local block of {shape[d]} along dim {d} "
                             f"does not split over {count} positions")
        block[d] = shape[d] // count
        shape[d] = block[d] * splits[i]
    blocks = {}
    for key in mine:
        index = [slice(None)] * local_block.ndim
        for i, d in enumerate(dims):
            j = key[i] - lo[i]
            index[d] = slice(j * block[d], (j + 1) * block[d])
        device = mesh.devices[_position(mesh, axes, key)]
        blocks[key] = local_block[tuple(index)].to(device).contiguous()
    return GlobalTensor(mesh, shape, dims, axes, blocks)


def _bounds(x: GlobalTensor, key):
    """``(start, stop)`` of a shard's block along every dim."""
    return [(0, n) if s.start is None else (s.start, s.stop)
            for s, n in zip(x.slices(key), x.shape)]


def _overlap(a, b):
    """The intersection of two blocks' bounds, or None."""
    out = [(max(x[0], y[0]), min(x[1], y[1])) for x, y in zip(a, b)]
    return None if any(lo >= hi for lo, hi in out) else out


def _within(region, bounds):
    """``region`` (global bounds) as an index into a block at ``bounds``."""
    return tuple(slice(lo - b[0], hi - b[0])
                 for (lo, hi), b in zip(region, bounds))


def resplit(x: GlobalTensor, layout: GlobalTensor) -> GlobalTensor:
    """``x`` split as ``layout`` (a GlobalTensor of the same shape and mesh;
    its blocks are not read). Each block of this process is assembled by
    copies from the blocks of ``x`` that overlap it; another process's
    blocks arrive by ``torch.distributed`` transfers, once for each
    receiving process. Bit for bit; ``x`` itself when the splits agree. A
    collective of every process of the mesh."""
    if x.matches(layout.dims, layout.axes):
        return x
    src_keys = x.keys()
    src_bounds = [_bounds(x, key) for key in src_keys]
    owners = [x.owner(key) for key in src_keys]
    blocks = [x.blocks.get(key) for key in src_keys]
    plan = {}
    for key in layout.keys():
        dst = _bounds(layout, key)
        plan[key] = [(i, region) for i, src in enumerate(src_bounds)
                     if (region := _overlap(src, dst)) is not None]
    pairs = sorted({(i, layout.owner(key)) for key, parts in plan.items()
                    for i, _ in parts if owners[i] != layout.owner(key)})
    template = _template(blocks)
    received = _transfer(pairs, blocks, owners, template) if pairs else {}
    rank, out = process_index(), {}
    for key, parts in plan.items():
        if layout.owner(key) != rank:
            continue
        device, dst = layout.device(key), _bounds(layout, key)
        block = torch.empty(layout.block_shape(), dtype=template.dtype,
                            device=device)
        for i, region in parts:
            src = blocks[i] if blocks[i] is not None else received[i]
            block[_within(region, dst)] = src[
                _within(region, src_bounds[i])].to(device)
        out[key] = block
    return GlobalTensor(x.mesh, x.shape, layout.dims, layout.axes, out)
