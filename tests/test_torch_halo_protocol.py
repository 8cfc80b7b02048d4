"""Kernel E's ordering protocol (kernels/cuda_halo.py:halo_plan) replayed
on the CPU: a row of 2-4 blocks issues up to 8 consecutive calls, each
block's stream running its plan's operations in order, and the streams
interleaved as hypothesis draws them. A stream wait holds its stream until
the counter reaches its value; a put, a write, the interior and the edges
happen at once when their stream reaches them. The replay fails on

- a deadlock: some stream has operations left and none can run;
- a stale or early read: an edges read that does not find its neighbour's
  put of the same call in the slot;
- an early put: a put into a slot whose last put has not been read yet;
- a wait on another block's memory, or a write into its own.

A one-slot plan without the "freed" waits must fail the replay, to show
that it can.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from nx_signal_tpu_torch.kernels.cuda_halo import halo_plan

# (left halo, right halo) of a call: the wrapper issues nothing for (0, 0)
PADS = [(True, True), (True, False), (False, True)]
NEIGHBOUR = {"left": -1, "right": 1}


class ProtocolError(AssertionError):
    pass


def streams(blocks, pads, plan=halo_plan):
    """Each block's operations for the calls `pads` (one (left, right) per
    call), each tagged with its call number."""
    return [[(call, op) for call, (left, right) in enumerate(pads, 1)
             for op in plan(b, blocks, call, left, right)[1]] for b in range(blocks)]


def replay(ops, choose):
    """Run the blocks' streams `ops` to their end, `choose(runnable)`
    picking which stream goes next among those that can; raises
    ProtocolError on a deadlock or a wrong read or put. Returns the reads,
    (block, call, side), in the order they happened."""
    counters, slots, reads = {}, {}, []
    pc = [0] * len(ops)

    def runnable(b):
        if pc[b] == len(ops[b]):
            return False
        _, op = ops[b][pc[b]]
        return op[0] != "wait" or counters.get((op[1], op[2]), 0) >= op[3]

    while any(pc[b] < len(ops[b]) for b in range(len(ops))):
        ready = [b for b in range(len(ops)) if runnable(b)]
        if not ready:
            stuck = [ops[b][pc[b]:pc[b] + 1] for b in range(len(ops))]
            raise ProtocolError(f"deadlock at {stuck}")
        b = choose(ready)
        call, op = ops[b][pc[b]]
        pc[b] += 1
        kind = op[0]
        if kind == "wait" and op[1] != b:
            raise ProtocolError(f"block {b} waits on block {op[1]}'s memory")
        if kind == "write":
            if abs(op[1] - b) != 1:
                raise ProtocolError(f"block {b} writes into block {op[1]}")
            counters[op[1], op[2]] = op[3]
        elif kind == "put":
            for owner, side, slot in op[1]:
                if owner + NEIGHBOUR[side] != b:
                    raise ProtocolError(f"block {b} puts into {owner}'s {side} slot")
                held = slots.get((owner, side, slot))
                if held is not None and not held[2]:
                    raise ProtocolError(f"block {b}'s put of call {call} into {owner}'s {side} "
                                        f"slot {slot} before call {held[1]}'s read")
                slots[owner, side, slot] = [b, call, False]
        elif kind == "edges":
            for owner, side, slot in op[1]:
                held = slots.get((owner, side, slot))
                if owner != b or held is None or held[:2] != [b + NEIGHBOUR[side], call]:
                    raise ProtocolError(f"block {b}'s call {call} reads its {side} slot {slot} "
                                        f"holding {held}")
                held[2] = True
                reads.append((b, call, side))
    return reads


def expected_reads(blocks, pads):
    """Every (block, call, side) that receives a halo."""
    return sorted((b, call, side) for call, (left, right) in enumerate(pads, 1)
                  for b in range(blocks)
                  for side, on in (("left", left and b > 0), ("right", right and b < blocks - 1))
                  if on)


def one_slot_without_freed_waits(b, blocks, call, left, right):
    """The plan with every slot 0 and no "freed" wait: a broken protocol."""
    _, ops = halo_plan(b, blocks, call, left, right)
    kept = []
    for op in ops:
        if op[0] == "wait" and op[2].startswith("freed"):
            continue
        if op[0] in ("put", "edges"):
            op = (op[0], tuple((owner, side, 0) for owner, side, _ in op[1]))
        kept.append(op)
    return 0, tuple(kept)


@pytest.mark.parametrize("blocks", [2, 3, 4])
@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(data=st.data())
def test_halo_protocol_never_deadlocks_nor_reads_wrong_data(blocks, data):
    pads = data.draw(st.lists(st.sampled_from(PADS), min_size=1, max_size=8), label="pads")
    reads = replay(streams(blocks, pads),
                   lambda ready: ready[data.draw(st.integers(0, len(ready) - 1))])
    assert sorted(reads) == expected_reads(blocks, pads)


@pytest.mark.parametrize("blocks", [2, 3, 4])
@pytest.mark.parametrize("pads", [PADS[1:2] * 8, PADS[2:3] * 8, PADS[:1] * 8, PADS * 3])
@pytest.mark.parametrize("first", ["lowest", "highest"])
def test_halo_protocol_when_one_block_runs_ahead(blocks, pads, first):
    """A block that always runs when it can (the lowest or the highest)
    runs as far ahead of the others as the waits allow."""
    pick = min if first == "lowest" else max
    reads = replay(streams(blocks, pads), pick)
    assert sorted(reads) == expected_reads(blocks, pads)


@pytest.mark.parametrize("pads", [PADS[1:2] * 3, PADS[2:3] * 3])
def test_halo_protocol_replay_catches_a_one_slot_plan(pads):
    """With one slot and no "freed" wait, the block that sends only one way
    overwrites its neighbour's slot before that neighbour has read it."""
    broken = streams(2, pads, one_slot_without_freed_waits)
    sender = 0 if pads[0] == (True, False) else 1
    with pytest.raises(ProtocolError, match="before call 1's read"):
        replay(broken, lambda ready: sender if sender in ready else ready[0])
    replay(streams(2, pads), lambda ready: sender if sender in ready else ready[0])


@pytest.mark.parametrize("blocks", [2, 4])
def test_halo_plan_waits_only_on_own_counters_and_alternates_slots(blocks):
    for b in range(blocks):
        for call in range(1, 6):
            slot, ops = halo_plan(b, blocks, call, True, True)
            assert slot == call % 2
            for op in ops:
                if op[0] == "wait":
                    assert op[1] == b and 1 <= op[3] <= call
                elif op[0] == "write":
                    assert abs(op[1] - b) == 1 and op[3] == call
                elif op[0] in ("put", "edges"):
                    assert all(s == slot for _, _, s in op[1])
            kinds = [op[0] for op in ops]
            if "edges" in kinds:
                assert kinds.index("interior") < kinds.index("edges")
            if "put" in kinds:
                assert kinds.index("put") < kinds.index("interior")
