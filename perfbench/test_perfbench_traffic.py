"""The one generator: the same seed gives the same inputs, a request
does not depend on what was drawn before it, and every seed serves the
same sizes in another order."""
import numpy as np
import pytest

from perfbench import harness
from perfbench.lib import gen

MIX = harness.mix_of("longprompt")


def test_same_seed_same_requests():
    a, b = gen.ServeStream(MIX, 151936, 2 ** 31 + 5), \
        gen.ServeStream(MIX, 151936, 2 ** 31 + 5)
    for i in (0, 7, 130):
        pa, na = a.request(i)
        pb, nb = b.request(i)
        assert na == nb and np.array_equal(pa, pb)


def test_requests_are_prefix_stable():
    s = gen.ServeStream(MIX, 151936, 99)
    later = s.request(200)
    fresh = gen.ServeStream(MIX, 151936, 99)
    for i in range(5):
        fresh.request(i)
    again = fresh.request(200)
    assert later[1] == again[1] and np.array_equal(later[0], again[0])


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 32 + 3])
def test_every_seed_serves_the_same_sizes(seed):
    ref = gen.ServeStream(MIX, 151936, 1)
    s = gen.ServeStream(MIX, 151936, seed)
    block = range(64, 128)
    assert sorted(s.lengths(i) for i in block) != \
        [s.lengths(i) for i in block]            # shuffled
    assert sorted(s.lengths(i)[0] for i in block) == \
        sorted(ref.lengths(i)[0] for i in block)
    assert sorted(s.lengths(i)[1] for i in block) == \
        sorted(ref.lengths(i)[1] for i in block)


def test_lengths_span_the_mix():
    s = gen.ServeStream(MIX, 151936, 3)
    p = [s.lengths(i)[0] for i in range(64)]
    o = [s.lengths(i)[1] for i in range(64)]
    assert 1024 <= min(p) < 1100 and 3800 < max(p) <= 3968
    assert min(o) == 1 and max(o) == 16
    ids, _ = s.request(0)
    assert ids.dtype == np.int32 and ids.min() >= 0 and ids.max() < 151936


def test_train_batches_differ_and_repeat():
    mix = harness.mix_of("train-4k")
    b = gen.TrainBatches(mix, 151936, 7)
    x0, x1 = b.batch(0), b.batch(1)
    assert x0.shape == (4, 4097) and np.array_equal(x0, b.batch(0))
    rows = [tuple(r[:64]) for r in np.concatenate([x0, x1])]
    assert len(set(rows)) == len(rows)


def test_rma_plan_samples_from_the_seed():
    mix = harness.mix_of("rma-large")
    a, b = gen.RmaPlan(mix, 5), gen.RmaPlan(mix, 5)
    kept = [r for r in range(10000) if a.sampled(r)]
    assert kept == [r for r in range(10000) if b.sampled(r)]
    assert len(kept) == 5
    assert {a.pattern(3, k) for k in range(3)} == {0, 1, 2}


def test_each_run_of_strata_holds_one_length_of_each_stratum():
    s = gen.ServeStream(MIX, 151936, 2 ** 31 + 77)
    per = MIX["block"] // MIX["strata"]
    ranks = {v: k for k, v in enumerate(gen.quantiles(
        MIX["prompt_tokens"], MIX["block"]))}
    for start in range(0, 2 * MIX["block"], MIX["strata"]):
        run = [s.lengths(i)[0] for i in range(start, start + MIX["strata"])]
        assert sorted(ranks[n] // per for n in run) == \
            list(range(MIX["strata"]))
