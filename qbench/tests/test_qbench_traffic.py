"""The traffic generator is a function of the seed: the same seed gives
the same requests, and every seed the same set of sizes in another order."""
import numpy as np
import pytest

from qbench import registry, traffic

MIXES = {n: registry._json(registry.HERE / "traffic" / f"{n}.json")
         for n in ("backlog",)}
SEED = 2**31 + 12345


def _draw(mix, seed, n=2000):
    log = traffic.Log(mix, mix["pool_images"], seed, n, capacity=64)
    for _ in range(n):
        log.add()
    rows = log.rows()
    return list(zip(rows["size"].tolist(), rows["start"].tolist(), rows["check"].tolist()))


@pytest.mark.parametrize("name", sorted(MIXES))
def test_same_seed_same_requests(name):
    mix = MIXES[name]
    assert _draw(mix, SEED) == _draw(mix, SEED)
    assert _draw(mix, SEED) != _draw(mix, SEED + 1)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_every_seed_the_same_sizes(name):
    mix = MIXES[name]
    a = sorted(s for s, _, _ in _draw(mix, SEED))
    b = sorted(s for s, _, _ in _draw(mix, 7))
    assert a == b
    assert min(a) == mix["size_min"] and max(a) == mix["size_max"]
    for size, start, _ in _draw(mix, SEED):
        assert 0 <= start <= mix["pool_images"] - size


@pytest.mark.parametrize("name,mean", [("backlog", 46.0)])
def test_log_uniform_mean(name, mean):
    sizes = traffic.size_set(MIXES[name], traffic.SIZE_SET)
    assert sizes.mean() == pytest.approx(mean, rel=0.02)


def test_pool_from_seed():
    mix = {"pool_images": 16}
    a = traffic.make_pool(mix, (4, 4, 3), SEED, "cpu")
    assert a.dtype == np.uint8 and a.shape == (16, 4, 4, 3)
    assert np.array_equal(a, traffic.make_pool(mix, (4, 4, 3), SEED, "cpu"))
    assert not np.array_equal(a, traffic.make_pool(mix, (4, 4, 3), SEED + 1, "cpu"))
