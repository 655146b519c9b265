"""The traffic generator: the same seed gives the same pool, every seed
the same lengths, the files' bucket shares, and the Switchboard fit."""
import math
from statistics import NormalDist

import numpy as np
import pytest

from ctcbench import generator, spec


def test_same_seed_same_pool():
    t = dict(spec.traffic_file("timit_lengths"), utterances=50)
    a = generator.make_pool(t, 2**33 + 1, 29, "cpu")
    b = generator.make_pool(t, 2**33 + 1, 29, "cpu")
    for (fa, la), (fb, lb) in zip(a, b):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)


def test_seeds_share_lengths_not_content():
    t = dict(spec.traffic_file("swbd_lengths"), utterances=50)
    a = generator.make_pool(t, 1, 29, "cpu")
    b = generator.make_pool(t, 2, 29, "cpu")
    assert [f.shape for f, _ in a] == [f.shape for f, _ in b]
    assert [len(lab) for _, lab in a] == [len(lab) for _, lab in b]
    assert not np.array_equal(a[0][0], b[0][0])
    assert all(lab.min() >= 1 and lab.max() <= 28 for _, lab in a)


@pytest.mark.parametrize("name,bounds,shares", [
    ("timit_lengths", (200, 400, 800), (0.1117, 0.7311, 0.1572)),
    ("swbd_lengths", (200, 400, 800, 1600), (0.3110, 0.3170, 0.24625, 0.12575)),
])
def test_bucket_shares(name, bounds, shares):
    t = spec.traffic_file(name)
    got = generator.bucket_shares(t, bounds)
    np.testing.assert_allclose(got, shares, atol=1e-4)
    frames, chars = generator.lengths(t)
    assert len(frames) == t["utterances"]
    assert frames.max() <= bounds[-1]
    # a label always fits its frames (CTC needs T >= L)
    assert (chars * 2 <= frames).all()


def test_switchboard_lengths_fit_the_recipe_counts():
    """The log-normal, before its clip, has the mean of the counts it was
    fitted to (hours over utterances) and the mean of its shortest
    100k / 260k (the recipe's 30k of them in ~12 h)."""
    t = spec.traffic_file("swbd_lengths")
    fit, d = t["fit"], t["seconds"]
    mu, sigma = math.log(d["median"]), d["sigma"]
    mean = math.exp(mu + sigma ** 2 / 2)
    assert mean == pytest.approx(fit["hours"] * 3600 / fit["utterances"],
                                 rel=5e-3)
    p = 100_000 / fit["utterances"]
    unit = NormalDist()
    short = mean * unit.cdf(unit.inv_cdf(p) - sigma) / p
    assert short == pytest.approx(
        fit["shortest_100000_sampled_30000_hours"] * 3600 / 30_000, rel=5e-3)
