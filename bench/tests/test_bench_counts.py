"""The benchmark's counts against hand-worked figures, the traffic
generator's sizes and seeds, and the profile's busy arithmetic."""
import numpy as np
import pytest

from bench import counts, harness, traffic
from bench.profile import Trace, busy_seconds, idle_by_host, idle_gaps

OLMO = {"n_layers": 16, "d_model": 2048, "n_heads": 16, "n_kv": 16,
        "head_dim": 0, "d_ff": 8192, "vocab": 50304, "mlp": "swiglu"}


def test_one_decode_call_by_hand():
    # flexpie's node call: 4 heads of 128 at 512 live keys, f32
    flops, nbytes = counts.decode_call_work(4, 4, 512, 128, 4)
    assert flops == 4 * 4 * 128 * 512 == 1_048_576
    # K and V: 2 x 4 rows x 512 keys x 128 x 4 bytes; q and out 2 x 4 x 128
    assert nbytes == 4 * 128 * (2 * 4 * 512 + 2 * 4) == 2_101_248
    assert counts.least_seconds(flops, nbytes) == pytest.approx(
        2_101_248 / 3.35e12)          # bytes-bound: 0.5 op a byte


def test_one_olmo_1b_step_by_hand():
    # a layer: q, k, v, o 4 x 2048 x 2048, the MLP 3 x 2048 x 8192
    layer = 2 * (4 * 2048 * 2048 + 3 * 2048 * 8192)
    assert layer == 134_217_728
    attn = 16 * 16 * 4 * 128 * 1024          # 1024 live keys
    logits = 2 * 2048 * 50304
    want = 16 * layer + attn + logits
    assert want == 2_487_746_560
    assert counts.token_flops(OLMO, 1024, logits=True) == want
    assert counts.token_flops(OLMO, 1024, logits=False) == want - logits


def test_steps_in_closed_form_equal_the_sum():
    for first, last, lg in ((0, 2048, True), (100, 357, False), (5, 5, True)):
        loop = sum(counts.token_flops(OLMO, t + 1, lg)
                   for t in range(first, last))
        assert counts.steps_flops(OLMO, first, last, lg) == \
            pytest.approx(loop, rel=1e-12)


def test_relu_blocks_count_two_matrices():
    w = dict(OLMO, mlp="relu")
    assert counts.block_matmul_flops(w) == 16 * 2 * (4 * 2048 ** 2
                                                     + 2 * 2048 * 8192)
    with pytest.raises(ValueError):
        counts.block_matmul_flops(dict(OLMO, mlp="gelu"))


def test_traffic_sizes_are_the_same_set_in_another_order_for_every_seed():
    mix = traffic.load("one-user.chat")
    pairs = traffic.sizes(mix)
    assert len(pairs) == 32 and len(set(pairs)) == 32
    assert min(p for p, _ in pairs) == 256 and max(p for p, _ in pairs) == 448
    assert {g for _, g in pairs} >= {32, 64}
    orders = []
    for seed in (1, 2**31 + 7, 3 * 2**31):
        gen = traffic.requests(mix, seed)
        reqs = [next(gen) for _ in range(64)]
        assert sorted((r.prompt_len, r.gen_len) for r in reqs[:32]) == \
            sorted(pairs)
        assert [r.index for r in reqs] == list(range(64))
        orders.append([(r.prompt_len, r.gen_len) for r in reqs[:32]])
    assert orders[0] != orders[1] != orders[2]


def test_a_request_draws_the_same_prompt_whatever_ran_before():
    import torch
    mix = traffic.load("batch32.short")
    a = [next(traffic.requests(mix, 99)) for _ in range(1)][0]
    gen = traffic.requests(mix, 99)
    b = next(gen)
    assert a == b
    ids = traffic.prompt_ids(b, 250, "cpu")
    assert ids.shape == (32, 128) and int(ids.max()) < 250
    assert torch.equal(ids, traffic.prompt_ids(b, 250, "cpu"))
    assert not torch.equal(ids, traffic.prompt_ids(next(gen), 250, "cpu"))


def test_busy_time_counts_overlapping_streams_once():
    spans = [("a", 0.0, 2.0, 1), ("b", 1.0, 3.0, 2), ("c", 5.0, 6.0, 1),
             ("d", 5.5, 5.7, 3)]
    assert busy_seconds(spans) == pytest.approx(4.0)
    assert idle_gaps(spans) == [(3.0, 5.0)]
    host = [("outer", 2.5, 6.0, 0), ("inner", 3.5, 4.5, 0),
            ("later", 4.4, 4.8, 0)]
    assert idle_by_host(Trace(spans, host, 6.0)) == {"inner": 2.0}


def test_the_sample_keeps_k_requests_and_the_first_longest_and_no_more():
    def served(steps):
        req = traffic.Request(0, 1, steps, 0, 0)
        return harness.Served(req, 0.0, 0.0, steps, [], {"steps": steps})
    picks = []
    for seed in range(200):
        keep = harness.Keep(2, np.random.default_rng(seed))
        done = []
        for i in range(10):
            done.append(served(50 if i in (3, 7) else 10 + i))
            if keep.offer(done):
                done[-1].kept = dict(done[-1].kept, kept=True)
            assert len(harness.sampled(done)) <= 3
        taken = [i for i, s in enumerate(done) if s.kept is not None]
        assert 3 in taken and 7 not in set(taken) - set(keep.sample)
        assert all(done[i].kept["kept"] for i in taken)
        picks += keep.sample
    # every request is as likely as any other to be among the two drawn
    tally = np.bincount(picks, minlength=10)
    assert tally.min() > 0.6 * 40 and tally.max() < 1.4 * 40
