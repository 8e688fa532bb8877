"""The port's copy of the continuous-batching scheduler against the JAX
package's: a handful of the JAX unit tests run against both modules, and
a randomised trace drives both side by side and requires identical
decisions tick by tick (admissions, chunks, decodes, preemptions,
copy-on-write pairs, block tables)."""

import importlib

import numpy as np
import pytest

MODULES = ["scaling_tpu.serve.scheduler", "scaling_tpu_torch.serve.scheduler"]


@pytest.fixture(params=MODULES, ids=["jax", "port"])
def sch(request):
    return importlib.import_module(request.param)


def make_sched(sch, **kw):
    cfg = dict(num_slots=4, block_size=2, num_blocks=16, max_blocks_per_seq=8,
               token_budget=64)
    cfg.update(kw)
    return sch.ContinuousBatchingScheduler(sch.SchedulerConfig(**cfg))


def submit(sch, sched, req_id, prompt_len=4, max_new=4, prompt=None):
    prompt = list(range(1, prompt_len + 1)) if prompt is None else list(prompt)
    return sched.add_request(sch.Request(req_id=req_id, prompt=prompt,
                                         max_new_tokens=max_new))


def settle(sched, tick):
    """What the engine does after a tick: chunks land, decodes emit."""
    chunk = sched.config.prefill_chunk
    for seq in tick.prefills:
        n = min(chunk, seq.prefill_len - seq.num_cached) if chunk else (
            seq.prefill_len - seq.num_cached)
        seq.num_cached += n
        if seq.num_cached == seq.prefill_len:
            seq.generated.append(1)
    for seq in tick.decodes:
        seq.num_cached += 1
        seq.generated.append(1)


def test_allocator_trash_block_and_double_free(sch):
    alloc = sch.BlockAllocator(4)
    blocks = alloc.alloc(3)
    assert 0 not in blocks
    with pytest.raises(RuntimeError, match="exhausted"):
        alloc.alloc(1)
    alloc.free(blocks[:1])
    with pytest.raises(ValueError, match="double free"):
        alloc.free(blocks[:1])
    with pytest.raises(ValueError):
        alloc.free([0])


def test_token_budget_limits_prefills_per_tick(sch):
    sched = make_sched(sch, token_budget=10)
    seqs = [submit(sch, sched, i) for i in range(4)]
    tick = sched.schedule()
    assert tick.prefills == seqs[:2]
    settle(sched, tick)
    tick2 = sched.schedule()
    assert tick2.prefills == seqs[2:] and tick2.decodes == seqs[:2]


def test_preemption_evicts_youngest(sch):
    sched = make_sched(sch, num_blocks=5)
    a, b = submit(sch, sched, 0), submit(sch, sched, 1)
    settle(sched, sched.schedule())
    tick = sched.schedule()
    assert tick.preempted == [b] and tick.decodes == [a]
    assert b.state is sch.SequenceState.WAITING and b.blocks == []
    assert len(sched.drain_freed_slots()) == 1


def test_chunked_prompt_streams_across_ticks(sch):
    sched = make_sched(sch, block_size=2, num_blocks=32, max_blocks_per_seq=16,
                       token_budget=8, prefill_chunk=4)
    a = submit(sch, sched, 0, prompt_len=10, max_new=2)
    for expected in (4, 8, 10):
        tick = sched.schedule()
        assert tick.prefills == [a] and tick.decodes == []
        settle(sched, tick)
        assert a.num_cached == expected
    assert sched.schedule().decodes == [a]


def test_prefix_admission_maps_cached_blocks(sch):
    sched = make_sched(sch, block_size=4, num_blocks=32, prefill_chunk=4,
                       token_budget=8)
    a = submit(sch, sched, 0, prompt=range(1, 13), max_new=2)
    while a.prefilling or a.slot is None:
        settle(sched, sched.schedule())
    b = submit(sch, sched, 1, prompt=list(range(1, 13)) + [50, 51], max_new=2)
    tick = sched.schedule()
    assert b in tick.prefills and b.num_cached == 12
    assert b.blocks[:3] == a.blocks[:3]
    assert sched.prefix_hit_tokens == 12


def test_fork_on_write_at_shared_block(sch):
    sched = make_sched(sch, block_size=4, num_blocks=32, prefill_chunk=4)
    a = submit(sch, sched, 0, prompt=range(1, 9), max_new=4)
    while a.prefilling or a.slot is None:
        settle(sched, sched.schedule())
    target = a.blocks[1]
    sched.allocator.incref(target)
    a.num_cached = 7
    tick = sched.schedule()
    assert len(tick.cow_pairs) == 1 and tick.cow_pairs[0][0] == target
    assert a.blocks[1] == tick.cow_pairs[0][1]


def test_port_decides_like_jax_on_a_random_trace():
    jax_s, port_s = (importlib.import_module(m) for m in MODULES)
    rng = np.random.default_rng(0)
    kw = dict(num_slots=4, block_size=4, num_blocks=12, max_blocks_per_seq=12,
              token_budget=24, prefill_chunk=8)
    scheds = [make_sched(jax_s, **kw), make_sched(port_s, **kw)]
    system = rng.integers(1, 50, size=8).tolist()
    live = [[], []]
    for step in range(120):
        if step < 60 and rng.random() < 0.4:
            prompt = (system if rng.random() < 0.5 else []) + rng.integers(
                1, 50, size=int(rng.integers(2, 20))).tolist()
            n = int(rng.integers(1, 10))
            for mod, sched, seqs in zip((jax_s, port_s), scheds, live):
                seqs.append(submit(mod, sched, step, prompt=prompt, max_new=n))
        ticks = [s.schedule() for s in scheds]

        def summary(t):
            return ([s.request.req_id for s in t.prefills],
                    [s.request.req_id for s in t.decodes],
                    [s.request.req_id for s in t.preempted], list(t.cow_pairs),
                    [list(s.blocks) for s in t.prefills + t.decodes])

        assert summary(ticks[0]) == summary(ticks[1]), f"diverged at tick {step}"
        for sched, t in zip(scheds, ticks):
            settle(sched, t)
            for seq in t.prefills + t.decodes:
                if seq.done and seq.slot is not None:
                    sched.finish(seq)
            sched.drain_freed_slots()
    assert scheds[0].preemption_count == scheds[1].preemption_count > 0
    assert scheds[0].prefix_hit_tokens == scheds[1].prefix_hit_tokens > 0
    assert [len(s.generated) for s in live[0]] == [len(s.generated) for s in live[1]]
