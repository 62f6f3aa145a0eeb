"""
The bookkeeping of K8's exchange across processes
(tpu_assim_torch.parallel.cuda_halo: CUDA IPC), which needs no card: the
slot size and layout of the exchange buffers, the cache of exchanges by
ring and its growth, and the order of one call's steps (``_call_plan``),
run on every process in random interleavings that respect the rendezvous,
with each wait on an interprocess event seeing the record it must see.
The exchange itself runs on the card (``chip_smoke.py`` phase 30) and, as
its plain version on the CPU, in tests/test_torch_multihost.py.
"""

import numpy as np
import pytest
import torch

from tpu_assim_torch.parallel import cuda_halo

torch.set_num_threads(1)


@pytest.mark.parametrize("nbytes, slot", [(1, 256), (256, 256), (257, 512),
                                          (43 * 128 * 4, 22016),
                                          (103 * 8192 * 4, 3375104)])
def test_slot_bytes(nbytes, slot):
    assert cuda_halo._slot_bytes(nbytes) == slot
    assert slot % cuda_halo.SLOT_ALIGN == 0 and slot >= nbytes


@pytest.mark.parametrize("owners", [[0] * 4 + [1] * 4, [0, 1, 1, 0, 2],
                                    [1, 1, 1, 0]])
def test_slot_layout(owners):
    """Each rank's slots tile its half in ring order; the two halves (call
    parities) of a buffer never overlap."""
    slot = 512
    offsets, halves = cuda_halo._slot_layout(owners, slot)
    for rank in set(owners):
        mine = [offsets[s] for s, r in enumerate(owners) if r == rank]
        assert mine == [j * slot for j in range(len(mine))]
        assert halves[rank] == len(mine) * slot
    assert sorted(halves) == sorted(set(owners))


class FakeExchange:
    """Stands in for ``_IpcExchange``, which needs a card."""

    log = []

    def __init__(self, owners, device, slot_bytes):
        self.owners, self.device, self.slot_bytes = owners, device, slot_bytes
        self.log.append(("made", tuple(owners), device, slot_bytes))

    def close(self):
        self.log.append(("closed", tuple(self.owners), self.device,
                         self.slot_bytes))


@pytest.fixture
def fake_exchanges(monkeypatch):
    FakeExchange.log = []
    monkeypatch.setattr(cuda_halo, "_IpcExchange", FakeExchange)
    monkeypatch.setattr(cuda_halo, "_EXCHANGES", {})
    return FakeExchange.log


def test_exchange_cache_and_growth(fake_exchanges):
    """One exchange per ring (owners) and card, kept while the blocks fit
    its slots, made again larger (the old one closed first) when a larger
    block arrives; release_exchanges closes every one in the order made."""
    ring, other = (0, 0, 1, 1), (0, 1, 1, 1)
    first = cuda_halo._exchange(ring, "cuda:0", 22016)
    assert cuda_halo._exchange(list(ring), "cuda:0", 1000) is first
    assert cuda_halo._exchange(ring, "cuda:0", 22016) is first
    second = cuda_halo._exchange(other, "cuda:0", 300)
    assert second is not first
    grown = cuda_halo._exchange(ring, "cuda:0", 3375104)
    assert grown is not first and grown.slot_bytes == 3375104
    assert fake_exchanges == [("made", ring, "cuda:0", 22016),
                              ("made", other, "cuda:0", 512),
                              ("closed", ring, "cuda:0", 22016),
                              ("made", ring, "cuda:0", 3375104)]
    del fake_exchanges[:]
    cuda_halo.release_exchanges()
    assert fake_exchanges == [("closed", other, "cuda:0", 512),
                              ("closed", ring, "cuda:0", 3375104)]
    assert cuda_halo._EXCHANGES == {}
    cuda_halo.release_exchanges()
    assert fake_exchanges == [("closed", other, "cuda:0", 512),
                              ("closed", ring, "cuda:0", 3375104)]


def interleave(plan, n_procs, n_calls, rng):
    """The host steps of ``n_calls`` calls of ``plan`` on ``n_procs``
    processes in one random order that respects the rendezvous (a barrier
    of every process). A record sets its event's last record to its call;
    a wait reads the last record of each other process's event of that
    kind and parity, as cudaStreamWaitEvent does. Returns what each wait
    read: (rank, call, kind, parity, other rank, call of the record read
    or None)."""
    steps = [[(c, step) for c in range(n_calls) for step in plan(c)]
             for _ in range(n_procs)]
    pos = [0] * n_procs
    arrived = {}
    last, seen = {}, []
    while any(pos[r] < len(steps[r]) for r in range(n_procs)):
        ready = []
        for r in range(n_procs):
            if pos[r] == len(steps[r]):
                continue
            c, step = steps[r][pos[r]]
            if step[0] == "rendezvous":
                arrived.setdefault(c, set()).add(r)
                if len(arrived[c]) < n_procs:
                    continue
            ready.append(r)
        assert ready, "the rendezvous deadlocked"
        r = ready[rng.randint(len(ready))]
        c, step = steps[r][pos[r]]
        pos[r] += 1
        if step[0] == "record":
            last[r, step[1], step[2]] = c
        elif step[0] == "wait":
            seen.extend((r, c, step[1], step[2], q, last.get((q,) + step[1:]))
                        for q in range(n_procs) if q != r)
    return seen


def stale(seen):
    """The waits that read another record than the one they must: the
    "written" of their own call (the other's copies of this call), the
    "read" of two calls before (the other's last read of this half)."""
    want = {"written": lambda c: c, "read": lambda c: c - 2 if c >= 2
            else None}
    return [s for s in seen if s[5] != want[s[2]](s[1])]


@pytest.mark.parametrize("n_procs", [2, 3])
def test_call_plan_orders_every_wait(n_procs):
    rng = np.random.RandomState(17)
    for _ in range(300):
        seen = interleave(cuda_halo._call_plan, n_procs, 6, rng)
        assert not stale(seen), stale(seen)[:5]
    # one rendezvous a call; the halves alternate
    assert [s[0] for s in cuda_halo._call_plan(0)].count("rendezvous") == 1
    assert {cuda_halo._call_plan(c)[0][2] for c in range(4)} == {0, 1}


def test_call_plan_without_its_rendezvous_goes_stale():
    """The check above can fail: without the rendezvous some order lets a
    wait read a stale record."""
    def plan(call):
        return tuple(s for s in cuda_halo._call_plan(call)
                     if s[0] != "rendezvous")

    rng = np.random.RandomState(17)
    assert any(stale(interleave(plan, 2, 6, rng)) for _ in range(300))
