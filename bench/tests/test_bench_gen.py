"""The traffic generator: the same seed gives the same inputs; another
seed changes the tokens and keeps every size."""

import pytest

from bench import core, gen

torch = pytest.importorskip("torch")


def test_token_batches_repeat_for_a_seed():
    t = {"batch": 4, "seq": 16}
    a = gen.TokenBatches(t, 100, 2**32 + 1, torch.device("cpu"))
    b = gen.TokenBatches(t, 100, 2**32 + 1, torch.device("cpu"))
    x, y = a.next(), a.next()
    assert torch.equal(x, b.next()) and torch.equal(y, b.next())
    assert not torch.equal(x, y) and x.shape == (4, 16)


def test_another_seed_keeps_the_sizes_of_every_traffic_file():
    for path in sorted((core.BENCH / "traffic").glob("*.json")):
        t = core.load_json(path)
        if t["kind"] != "train":
            continue
        a = gen.TokenBatches(t, 50304, 7, torch.device("cpu")).next()
        b = gen.TokenBatches(t, 50304, 2**33 + 5, torch.device("cpu")).next()
        assert a.shape == b.shape == (t["batch"], t["seq"])
        assert not torch.equal(a, b)
        assert int(a.min()) >= 0 and int(a.max()) < 50304
