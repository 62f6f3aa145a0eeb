"""
K8: the halo exchange of the obs-sharded LETKF as a hand-written CUDA
kernel (the port of :func:`tpu_assim.parallel.halo._ring_halo_rdma`), with
its plain PyTorch twin.

Both take the packed observation blocks of every shard of a ring, in ring
order, and return each shard's candidates: its own block, then the block
of shard ``(s - off) mod n`` for each distinct ring offset ``off`` of the
halo (:func:`_halo_offsets`), concatenated along the last dimension.
:func:`ring_halo_plain` does it with ``.to(device)`` copies and
``torch.cat``; :func:`ring_halo_rdma` runs it for CPU shards and launches
``csrc/halo_ring.cu`` for CUDA shards: one launch per device for all of
its shards, reading the other devices' blocks through peer pointers.

On a ring that spans processes (``owners``), the plain exchange takes
another process's blocks by ``torch.distributed`` transfers
(:func:`tpu_assim_torch.parallel.multihost.exchange_blocks`), which gloo
stages through host memory. K8 reads them through CUDA IPC instead
(:class:`_IpcExchange`): each process copies its own shards' blocks into
an exchange buffer that the other processes have mapped, and launches K8
once for all of its shards, with the mapped slots as the sources of the
other processes' shards. No block goes through the host. CUDA IPC reaches
the processes of one node only, so
:func:`tpu_assim_torch.parallel.halo.halo_letkf_analysis` refuses
``comm="rdma"`` on a mesh whose processes sit on several hosts. Every
process calls :func:`release_exchanges` before it destroys its process
group (:func:`tpu_assim_torch.parallel.multihost.shutdown_multihost` does
both): it unmaps and frees the exchange buffers in order.
"""

import ctypes
import functools
from collections import Counter

import torch
import torch.distributed as dist

from tpu_assim_torch.parallel.multihost import exchange_blocks, process_index

__all__ = ["LAUNCHES", "release_exchanges", "ring_halo_plain",
           "ring_halo_rdma"]

# Launches of the CUDA kernel, counted by its wrapper.
LAUNCHES = {"halo_ring": 0}
# Slots of an exchange buffer start on this alignment: K8's 16-byte route
# and cudaMalloc's own.
SLOT_ALIGN = 256


def _halo_offsets(n_shards: int, halo_width: int):
    """Distinct nonzero ring offsets within the halo. On small rings the
    +h and -h hops can alias (e.g. n=2: +1 == -1); an aliased block taken
    twice would double-count its observations in the weighted Gram, so
    each distinct source shard appears once."""
    seen, offsets = {0}, []
    for h in range(1, halo_width + 1):
        for off in (h % n_shards, (-h) % n_shards):
            if off not in seen:
                seen.add(off)
                offsets.append(off)
    return offsets


def _check_blocks(blocks, n_shards: int) -> None:
    if len(blocks) != n_shards:
        raise ValueError(f"{len(blocks)} blocks for a ring of {n_shards} "
                         "shards")
    held = [b for b in blocks if b is not None]
    first = held[0]
    if first.ndim != 2 or any(b.shape != first.shape or b.dtype != first.dtype
                              for b in held):
        raise ValueError(
            "the halo exchange takes one [rows, cols] block per shard, all "
            "of one shape and dtype; got "
            + ", ".join(f"{tuple(b.shape)} {b.dtype}" for b in held))


def ring_halo_plain(blocks, n_shards: int, halo_width: int, owners=None):
    """The halo exchange by copies: shard ``s`` gets
    ``cat([blocks[s]] + [blocks[(s - off) % n] for off in offsets], -1)``
    on its own device, the layout of the JAX package's ``_ring_halo``. With
    no offsets each shard keeps its block.

    ``owners``: the rank of each shard's process on a ring that spans
    processes (``blocks`` None where another process holds a shard, and so
    is the result); None: one process holds every shard."""
    _check_blocks(blocks, n_shards)
    offsets = _halo_offsets(n_shards, halo_width)
    if not offsets:
        return list(blocks)
    got = exchange_blocks(blocks, [[(s - off) % n_shards for off in offsets]
                                   for s in range(n_shards)], owners)
    return [None if parts is None else torch.cat([blocks[s]] + parts, dim=-1)
            for s, parts in enumerate(got)]


@functools.lru_cache(maxsize=None)
def _halo_lib():
    from tpu_assim_torch._build import load_library

    lib = load_library("halo_ring")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    out = ctypes.POINTER(ptr)
    for name, args in (
            ("halo_ring_launch", [out, out, ctypes.POINTER(i32), i32, i32,
                                  ctypes.POINTER(i32), i32, i64, i64, ptr]),
            ("halo_ring_enable_peer", [i32, i32]),
            ("halo_ring_max_shards", []),
            ("halo_ipc_handle_size", []),
            ("halo_ipc_alloc", [out, i64]),
            ("halo_ipc_free", [ptr]),
            ("halo_ipc_mem_handle", [ptr, ptr]),
            ("halo_ipc_open_mem", [ptr, out]),
            ("halo_ipc_close_mem", [ptr]),
            ("halo_ipc_event_create", [out]),
            ("halo_ipc_event_handle", [ptr, ptr]),
            ("halo_ipc_open_event", [ptr, out]),
            ("halo_ipc_event_destroy", [ptr]),
            ("halo_ipc_record", [ptr, ptr]),
            ("halo_ipc_wait", [ptr, ptr]),
            ("halo_ipc_put", [ptr, out, i32, i64, i64, ptr])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i32
    lib.halo_ring_error_string.argtypes = [i32]
    lib.halo_ring_error_string.restype = ctypes.c_char_p
    return lib


def _cuda(err: int, what: str) -> None:
    """Raise with cudaGetErrorString when a CUDA call of the library
    returned an error."""
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           + _halo_lib().halo_ring_error_string(err).decode())


@functools.lru_cache(maxsize=None)
def _enable_peer(device: int, peer: int) -> None:
    """Peer access from ``device`` to ``peer``, enabled once per pair."""
    lib = _halo_lib()
    err = lib.halo_ring_enable_peer(device, peer)
    if err != 0:
        raise RuntimeError(
            f"cuda:{device} cannot read cuda:{peer}'s memory for the halo "
            "exchange: " + lib.halo_ring_error_string(err).decode())


def _check_kernel_blocks(held, n: int) -> None:
    """What K8 takes: at most its shard count, 4-byte words, contiguous
    blocks, no gradient."""
    max_shards = _halo_lib().halo_ring_max_shards()
    if n > max_shards:
        raise ValueError(f"the halo kernel takes at most {max_shards} "
                         f"shards; got {n}")
    if held[0].element_size() % 4:
        raise TypeError(f"the halo kernel copies 4-byte words; got "
                        f"{held[0].dtype}")
    if any(b.requires_grad for b in held):
        raise NotImplementedError(
            "the CUDA kernel halo_ring has no VJP, as the JAX package's RDMA "
            "exchange has none: comm='ppermute' (ring_halo_plain) "
            "differentiates")
    if not all(b.is_contiguous() for b in held):
        raise ValueError("the CUDA kernel halo_ring needs contiguous blocks")


def _launch(src, local, device, like, slot_offsets):
    """One K8 launch on ``device``'s current stream for the shards
    ``local`` (ring indices): ``src`` holds the address of every shard's
    block, ``like`` is one of them. Returns the outputs of ``local``,
    [rows, n_slots * cols] each."""
    n, n_slots = len(src), len(slot_offsets)
    rows, cols = like.shape
    out = torch.empty((len(local), rows, n_slots * cols), dtype=like.dtype,
                      device=device)
    lib = _halo_lib()
    with torch.cuda.device(device):
        err = lib.halo_ring_launch(
            (ctypes.c_void_p * n)(*src),
            (ctypes.c_void_p * len(local))(*(o.data_ptr() for o in out)),
            (ctypes.c_int * len(local))(*local), len(local), n,
            (ctypes.c_int * n_slots)(*slot_offsets), n_slots, rows,
            cols * like.element_size() // 4,
            torch.cuda.current_stream(device).cuda_stream)
    _cuda(err, "halo_ring kernel launch")
    LAUNCHES["halo_ring"] += 1
    return list(out)


def _launch_halo_ring(blocks, slot_offsets):
    """K8 in one process: one launch per device, another device's blocks
    read through peer pointers."""
    n = len(blocks)
    src = [b.data_ptr() for b in blocks]
    by_device = {}
    for s, b in enumerate(blocks):
        by_device.setdefault(b.device, []).append(s)
    outs = [None] * n
    for device, local in by_device.items():
        peers = {blocks[(s - off) % n].device for s in local
                 for off in slot_offsets} - {device}
        for peer in peers:
            _enable_peer(device.index, peer.index)
        stream = torch.cuda.current_stream(device)
        # each source device's stream has written its block before the read
        for peer in peers:
            written = torch.cuda.Event()
            written.record(torch.cuda.current_stream(peer))
            stream.wait_event(written)
        for s, out in zip(local, _launch(src, local, device, blocks[local[0]],
                                         slot_offsets)):
            outs[s] = out
        if peers:
            # the sources are not reused before this launch has read them
            read = torch.cuda.Event()
            read.record(stream)
            for peer in peers:
                torch.cuda.current_stream(peer).wait_event(read)
    return outs


# -- across the processes of one node: CUDA IPC -------------------------------

def _slot_bytes(nbytes: int) -> int:
    """The slot of an exchange buffer for a block of ``nbytes``: rounded up
    to SLOT_ALIGN."""
    return -(-nbytes // SLOT_ALIGN) * SLOT_ALIGN


def _slot_layout(owners, slot_bytes: int):
    """Where each shard's block lies in its owner's exchange buffer. A
    buffer has two halves, one per call parity, each a slot of
    ``slot_bytes`` per shard of its owner, in ring order. Returns the byte
    offset of each shard's slot in its owner's half, and the size of each
    rank's half."""
    seen, offsets = Counter(), []
    for rank in owners:
        offsets.append(seen[rank] * slot_bytes)
        seen[rank] += 1
    return offsets, {rank: count * slot_bytes
                     for rank, count in seen.items()}


def _call_plan(call: int):
    """The steps of the ``call``-th exchange on one ring, the same on every
    process; ``p`` is the call's parity, the half of the buffers it uses.

    1. ``("wait", "read", p)``: this process's stream waits for every
       other process's "read" event of parity ``p``, recorded after its K8
       launch of call ``call - 2``, the last that read half ``p`` of this
       buffer;
    2. ``("put", p)``: this process's blocks into half ``p``;
    3. ``("record", "written", p)``;
    4. ``("rendezvous",)``: a host barrier of every process;
    5. ``("wait", "written", p)``: the stream waits for every other
       process's "written" event: its copies of this call;
    6. ``("launch", p)``: K8, reading the others' halves ``p``;
    7. ``("record", "read", p)``.

    A wait on an interprocess event sees only the records made before the
    wait call, so the rendezvous puts every process's step 3 before any
    step 5 of this call. One rendezvous a call suffices because the halves
    alternate: a process's step 1 of call ``c`` comes after the rendezvous
    of call ``c - 1``, which every process entered after its step 7 of
    call ``c - 2``, and before the rendezvous of call ``c``, which no
    process leaves before this one has entered it, so no step 7 of call
    ``c`` can precede it. Nothing waits on the device for the other
    process: two processes on one card time-slice their contexts, so a
    kernel that spins on a flag set by the other could hold the card for a
    whole slice or hang."""
    p = call % 2
    return (("wait", "read", p), ("put", p), ("record", "written", p),
            ("rendezvous",), ("wait", "written", p), ("launch", p),
            ("record", "read", p))


_EVENTS = (("written", 0), ("written", 1), ("read", 0), ("read", 1))


class _IpcExchange:
    """This process's side of K8's exchange on one ring that spans the
    processes of a node: its exchange buffer and four interprocess events
    ("written" and "read" per parity), the other processes' buffers mapped
    and their events opened. Made by every process together (the handles
    are swapped by ``all_gather_object``). This process's shards lie on
    one card, ``device``."""

    def __init__(self, owners, device, slot_bytes: int):
        lib = _halo_lib()
        self.owners, self.device = list(owners), device
        self.slot_bytes, self.calls = slot_bytes, 0
        self.rank = process_index()
        self.offsets, self.halves = _slot_layout(owners, slot_bytes)
        self.mine = [s for s, r in enumerate(owners) if r == self.rank]
        # the rendezvous and the swap stay on the host under any backend
        self.group = (None if dist.get_backend() == "gloo"
                      else dist.new_group(backend="gloo"))
        self.events, self.remote, self.remote_events = {}, {}, {}
        size = lib.halo_ipc_handle_size()
        handle = ctypes.create_string_buffer(size)
        with torch.cuda.device(device):
            base = ctypes.c_void_p()
            _cuda(lib.halo_ipc_alloc(ctypes.byref(base),
                                     2 * self.halves[self.rank]),
                  "cudaMalloc of the halo exchange buffer")
            self.base = base.value
            _cuda(lib.halo_ipc_mem_handle(self.base, handle),
                  "cudaIpcGetMemHandle")
            table = {"mem": handle.raw}
            for key in _EVENTS:
                event = ctypes.c_void_p()
                _cuda(lib.halo_ipc_event_create(ctypes.byref(event)),
                      "cudaEventCreate (interprocess)")
                self.events[key] = event.value
                _cuda(lib.halo_ipc_event_handle(event, handle),
                      "cudaIpcGetEventHandle")
                table[key] = handle.raw
            tables = [None] * dist.get_world_size()
            dist.all_gather_object(tables, table, group=self.group)
            for rank in sorted(set(owners) - {self.rank}):
                # Each process opens the others' handles (CUDA cannot open
                # its own). On a card of its own, as torchrun lays the
                # processes out, the mapping reads through peer access
                # (cudaIpcMemLazyEnablePeerAccess): unverified, it needs
                # two cards; two processes sharing one card are checked.
                mapped = ctypes.c_void_p()
                _cuda(lib.halo_ipc_open_mem(tables[rank]["mem"],
                                            ctypes.byref(mapped)),
                      f"cudaIpcOpenMemHandle of rank {rank}'s buffer")
                self.remote[rank] = mapped.value
                for key in _EVENTS:
                    event = ctypes.c_void_p()
                    _cuda(lib.halo_ipc_open_event(tables[rank][key],
                                                  ctypes.byref(event)),
                          f"cudaIpcOpenEventHandle of rank {rank}'s event")
                    self.remote_events[rank, key] = event.value

    def source(self, s: int, p: int) -> int:
        """The mapped address of another process's shard ``s`` in half
        ``p``."""
        rank = self.owners[s]
        return self.remote[rank] + p * self.halves[rank] + self.offsets[s]

    def __call__(self, blocks, slot_offsets):
        lib = _halo_lib()
        like = blocks[self.mine[0]]
        nbytes = like.numel() * like.element_size()
        call, p = self.calls, self.calls % 2
        self.calls += 1
        stream = torch.cuda.current_stream(self.device).cuda_stream
        src = [blocks[s].data_ptr() if r == self.rank else self.source(s, p)
               for s, r in enumerate(self.owners)]
        own = (ctypes.c_void_p * len(self.mine))(
            *(blocks[s].data_ptr() for s in self.mine))
        outs = [None] * len(blocks)
        with torch.cuda.device(self.device):
            for step in _call_plan(call):
                if step[0] == "wait":
                    for rank in self.remote:
                        _cuda(lib.halo_ipc_wait(
                            stream, self.remote_events[rank, step[1:]]),
                            "cudaStreamWaitEvent (interprocess)")
                elif step[0] == "put":
                    _cuda(lib.halo_ipc_put(
                        self.base + p * self.halves[self.rank], own,
                        len(self.mine), nbytes, self.slot_bytes, stream),
                        "the copy into the halo exchange buffer")
                elif step[0] == "record":
                    _cuda(lib.halo_ipc_record(self.events[step[1:]], stream),
                          "cudaEventRecord (interprocess)")
                elif step[0] == "rendezvous":
                    dist.barrier(group=self.group)
                else:
                    for s, out in zip(self.mine, _launch(
                            src, self.mine, self.device, like,
                            slot_offsets)):
                        outs[s] = out
        return outs

    def close(self) -> None:
        """Unmap the others' buffers, then free this one, in order: after
        this process's reads have ended (a device sync) and every process
        has unmapped (a rendezvous). A collective."""
        lib = _halo_lib()
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            for event in self.remote_events.values():
                _cuda(lib.halo_ipc_event_destroy(event),
                      "cudaEventDestroy of an opened event")
            for mapped in self.remote.values():
                _cuda(lib.halo_ipc_close_mem(mapped), "cudaIpcCloseMemHandle")
            dist.barrier(group=self.group)
            for event in self.events.values():
                _cuda(lib.halo_ipc_event_destroy(event), "cudaEventDestroy")
            _cuda(lib.halo_ipc_free(self.base),
                  "cudaFree of the halo exchange buffer")
        if self.group is not None:
            dist.destroy_process_group(self.group)


# This process's exchanges, by ring (owners) and card, in the order every
# process made them.
_EXCHANGES = {}


def _exchange(owners, device, nbytes: int):
    """The exchange of this ring, made at its first call and made again,
    larger, when a larger block arrives (every process sees the same
    blocks' size, so all of them decide alike)."""
    key = (tuple(owners), device)
    exchange = _EXCHANGES.get(key)
    if exchange is not None and exchange.slot_bytes < nbytes:
        _EXCHANGES.pop(key).close()
        exchange = None
    if exchange is None:
        exchange = _EXCHANGES[key] = _IpcExchange(owners, device,
                                                  _slot_bytes(nbytes))
    return exchange


def release_exchanges() -> None:
    """Unmap and free every exchange buffer that K8 made across processes,
    in the order they were made. A collective: every process calls it
    before ``torch.distributed.destroy_process_group()``. Nothing to do
    where none was made."""
    for key in list(_EXCHANGES):
        _EXCHANGES.pop(key).close()


def ring_halo_rdma(blocks, n_shards: int, halo_width: int, owners=None):
    """The halo exchange of :func:`ring_halo_plain`, bit for bit: the plain
    version for shards on the CPU, kernel K8 for shards on CUDA devices
    (one launch per device, for all of its shards; another device's blocks
    are read through peer pointers, another process's through CUDA IPC).
    Shards that mix the CPU and CUDA raise. With no offsets each shard
    keeps its block, and nothing is launched.

    Parameters
    ----------
    blocks : ``n_shards`` tensors [rows, cols] of one shape and dtype, in
        ring order (f32, f64 and int32 are copied bit for bit); None where
        another process holds a shard.
    n_shards : the ring's size; halo_width : the hops on each side.
    owners : the rank of each shard's process on a ring that spans
        processes, as in :func:`ring_halo_plain`; None: one process.

    Across processes every process calls it with the same ring and block
    shape (a collective). Its own shards lie on one card, as under
    ``torchrun`` (a process per card) or with several processes sharing
    one; it copies them into its exchange buffer, and its one launch reads
    the other processes' shards from theirs. The buffers have two halves
    that alternate calls, so one host rendezvous (a gloo barrier) a call
    puts every copy before the reads of that call and every read before
    the copy that overwrites it, through interprocess events
    (:func:`_call_plan`); no kernel spins on the other process. The
    buffers live until :func:`release_exchanges`.

    Returns the ``n_shards`` candidate blocks [rows, (1 + n_off) * cols],
    each on its shard's device (None where another process holds it).
    """
    _check_blocks(blocks, n_shards)
    offsets = _halo_offsets(n_shards, halo_width)
    if not offsets:
        return list(blocks)
    held = [b for b in blocks if b is not None]
    kinds = {b.device.type for b in held}
    if kinds == {"cpu"}:
        return ring_halo_plain(blocks, n_shards, halo_width, owners)
    if kinds != {"cuda"}:
        raise ValueError(f"shards on {sorted(kinds)}: the halo exchange "
                         "takes shards all on the CPU or all on CUDA devices")
    _check_kernel_blocks(held, n_shards)
    if owners is None or len(set(owners)) == 1:
        return _launch_halo_ring(blocks, [0] + offsets)
    devices = {b.device for b in held}
    if len(devices) > 1:
        raise NotImplementedError(
            "across processes K8 takes each process's shards on one card "
            f"(a process per card, as torchrun starts them); this process "
            f"holds shards on {sorted(map(str, devices))}")
    like = held[0]
    return _exchange(owners, like.device,
                     like.numel() * like.element_size())(blocks,
                                                         [0] + offsets)
