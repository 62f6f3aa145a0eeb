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
"""

import ctypes
import functools

import torch

__all__ = ["LAUNCHES", "ring_halo_plain", "ring_halo_rdma"]

# Launches of the CUDA kernel, counted by its wrapper.
LAUNCHES = {"halo_ring": 0}



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
    first = blocks[0]
    if first.ndim != 2 or any(b.shape != first.shape or b.dtype != first.dtype
                              for b in blocks):
        raise ValueError(
            "the halo exchange takes one [rows, cols] block per shard, all "
            "of one shape and dtype; got "
            + ", ".join(f"{tuple(b.shape)} {b.dtype}" for b in blocks))


def ring_halo_plain(blocks, n_shards: int, halo_width: int):
    """The halo exchange by copies: shard ``s`` gets
    ``cat([blocks[s]] + [blocks[(s - off) % n] for off in offsets], -1)``
    on its own device, the layout of the JAX package's ``_ring_halo``. With
    no offsets each shard keeps its block."""
    _check_blocks(blocks, n_shards)
    offsets = _halo_offsets(n_shards, halo_width)
    if not offsets:
        return list(blocks)
    return [torch.cat([blocks[s]] + [blocks[(s - off) % n_shards].to(
        blocks[s].device) for off in offsets], dim=-1)
        for s in range(n_shards)]


@functools.lru_cache(maxsize=None)
def _halo_lib():
    from tpu_assim_torch._build import load_library

    lib = load_library("halo_ring")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.halo_ring_launch.argtypes = [
        ctypes.POINTER(ptr), ctypes.POINTER(ptr), ctypes.POINTER(i32), i32,
        i32, ctypes.POINTER(i32), i32, i64, i64, ptr]
    lib.halo_ring_launch.restype = i32
    lib.halo_ring_enable_peer.argtypes = [i32, i32]
    lib.halo_ring_enable_peer.restype = i32
    lib.halo_ring_max_shards.argtypes = []
    lib.halo_ring_max_shards.restype = i32
    lib.halo_ring_error_string.argtypes = [i32]
    lib.halo_ring_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _enable_peer(device: int, peer: int) -> None:
    """Peer access from ``device`` to ``peer``, enabled once per pair."""
    lib = _halo_lib()
    err = lib.halo_ring_enable_peer(device, peer)
    if err != 0:
        raise RuntimeError(
            f"cuda:{device} cannot read cuda:{peer}'s memory for the halo "
            "exchange: " + lib.halo_ring_error_string(err).decode())


def _launch_halo_ring(blocks, slot_offsets):
    lib = _halo_lib()
    n = len(blocks)
    if n > lib.halo_ring_max_shards():
        raise ValueError(f"the halo kernel takes at most "
                         f"{lib.halo_ring_max_shards()} shards; got {n}")
    first = blocks[0]
    if first.element_size() % 4:
        raise TypeError(f"the halo kernel copies 4-byte words; got "
                        f"{first.dtype}")
    if any(b.requires_grad for b in blocks):
        raise NotImplementedError(
            "the CUDA kernel halo_ring has no VJP, as the JAX package's RDMA "
            "exchange has none: comm='ppermute' (ring_halo_plain) "
            "differentiates")
    if not all(b.is_contiguous() for b in blocks):
        raise ValueError("the CUDA kernel halo_ring needs contiguous blocks")
    rows, cols = first.shape
    words = cols * first.element_size() // 4
    n_slots = len(slot_offsets)
    src = (ctypes.c_void_p * n)(*(b.data_ptr() for b in blocks))
    offsets = (ctypes.c_int * n_slots)(*slot_offsets)
    by_device = {}
    for s, b in enumerate(blocks):
        by_device.setdefault(b.device, []).append(s)
    outs = [None] * n
    for device, local in by_device.items():
        peers = {blocks[(s - off) % n].device for s in local
                 for off in slot_offsets} - {device}
        for peer in peers:
            _enable_peer(device.index, peer.index)
        out = torch.empty((len(local), rows, n_slots * cols),
                          dtype=first.dtype, device=device)
        stream = torch.cuda.current_stream(device)
        # each source device's stream has written its block before the read
        for peer in peers:
            written = torch.cuda.Event()
            written.record(torch.cuda.current_stream(peer))
            stream.wait_event(written)
        dst = (ctypes.c_void_p * len(local))(
            *(out[i].data_ptr() for i in range(len(local))))
        shards = (ctypes.c_int * len(local))(*local)
        with torch.cuda.device(device):
            err = lib.halo_ring_launch(src, dst, shards, len(local), n,
                                       offsets, n_slots, rows, words,
                                       stream.cuda_stream)
        if err != 0:
            raise RuntimeError("halo_ring kernel launch failed: "
                               + lib.halo_ring_error_string(err).decode())
        LAUNCHES["halo_ring"] += 1
        if peers:
            # the sources are not reused before this launch has read them
            read = torch.cuda.Event()
            read.record(stream)
            for peer in peers:
                torch.cuda.current_stream(peer).wait_event(read)
        for i, s in enumerate(local):
            outs[s] = out[i]
    return outs


def ring_halo_rdma(blocks, n_shards: int, halo_width: int):
    """The halo exchange of :func:`ring_halo_plain`, bit for bit: the plain
    version for shards on the CPU, kernel K8 for shards on CUDA devices
    (one launch per device, for all of its shards; another device's blocks
    are read through peer pointers). Shards that mix the CPU and CUDA
    raise. With no offsets each shard keeps its block, and nothing is
    launched.

    Parameters
    ----------
    blocks : ``n_shards`` tensors [rows, cols] of one shape and dtype, in
        ring order (f32, f64 and int32 are copied bit for bit).
    n_shards : the ring's size; halo_width : the hops on each side.

    Returns the ``n_shards`` candidate blocks [rows, (1 + n_off) * cols],
    each on its shard's device.
    """
    _check_blocks(blocks, n_shards)
    offsets = _halo_offsets(n_shards, halo_width)
    if not offsets:
        return list(blocks)
    kinds = {b.device.type for b in blocks}
    if kinds == {"cpu"}:
        return ring_halo_plain(blocks, n_shards, halo_width)
    if kinds != {"cuda"}:
        raise ValueError(f"shards on {sorted(kinds)}: the halo exchange "
                         "takes shards all on the CPU or all on CUDA devices")
    return _launch_halo_ring(blocks, [0] + offsets)
