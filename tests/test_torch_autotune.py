"""The port's persistent tile autotune cache (``repro_torch.kernels.dispatch``)
against the reference's (``tests/test_autotune_cache.py``): disk round
trip, the zero-re-tune restart, a corrupt file, a stale entry, the
directory override and persistence off; then the tile the dense and
paged decode launchers take (``decode_attention.chunk_candidates``), the
per-device file name, and the commands' ``--autotune-cache-dir``, which
sets the directory for the run only.  Each case runs the same calls
through ``repro.kernels.dispatch`` and compares what both caches did."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention, dispatch  # noqa: E402


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Every test gets fresh cache dirs (one each package) and clean
    counters."""
    from repro.kernels import dispatch as jdispatch
    monkeypatch.setenv(dispatch.ENV_CACHE_DIR, str(tmp_path))
    dispatch.clear_autotune_cache()
    jdispatch.clear_autotune_cache()
    yield tmp_path
    dispatch.clear_autotune_cache()
    jdispatch.clear_autotune_cache()


def _tune(mod, op="op_cache", key=("k",), cands=((128, 128), (64, 64))):
    return mod.tuned_blocks(op, key, list(cands), bench=lambda *a: None,
                            args=())


def _both(fn):
    """``fn(dispatch module)`` for the port, then for the reference with
    its cache in a sibling directory; returns (port, reference)
    results."""
    from repro.kernels import dispatch as jdispatch
    port = fn(dispatch)
    here = os.environ[dispatch.ENV_CACHE_DIR]
    os.environ[dispatch.ENV_CACHE_DIR] = here + "-reference"
    try:
        return port, fn(jdispatch)
    finally:
        os.environ[dispatch.ENV_CACHE_DIR] = here


def test_round_trip_to_disk(tmp_path):
    def run(mod):
        out = [_tune(mod)]
        path = mod.autotune_cache_path()
        out.append(list(json.loads(path.read_text()).values()))
        out.append(mod.autotune_cache_stats())
        # a fresh process (simulated: clear the in-process layer)
        # re-tunes nothing: the disk entry serves
        mod.clear_autotune_cache()
        out.append(_tune(mod))
        out.append(mod.autotune_cache_stats())
        # and subsequent same-process calls hit the in-memory layer
        out.append(_tune(mod))
        out.append(mod.autotune_cache_stats())
        return out, path
    (port, path), (want, _) = _both(run)
    assert path.parent == tmp_path
    assert port == want
    assert port[0] == (128, 128) and port[1] == [[128, 128]]
    assert port[2] == {"tuned": 1, "disk_writes": 1}
    assert port[4] == {"disk_hits": 1}
    assert port[6] == {"disk_hits": 1, "memory_hits": 1}


def test_zero_retunes_after_restart_many_entries():
    """After persistence, a second in-process run performs zero re-tunes
    (the hit counters prove it)."""
    def run(mod):
        for i in range(5):
            _tune(mod, key=(f"shape{i}",), cands=((256,), (128,)))
        first = mod.autotune_cache_stats()
        mod.clear_autotune_cache()               # "restart"
        for i in range(5):
            _tune(mod, key=(f"shape{i}",), cands=((256,), (128,)))
        return first, mod.autotune_cache_stats()
    port, want = _both(run)
    assert port == want
    assert port[0]["tuned"] == 5
    assert port[1].get("tuned", 0) == 0 and port[1]["disk_hits"] == 5


def test_corrupt_file_recovers_by_retuning():
    def run(mod):
        path = mod.autotune_cache_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("{not json!!")
        got = _tune(mod)                         # fell back to a fresh tune
        stats = mod.autotune_cache_stats()
        # the re-tune rewrote the file into a loadable state
        mod.clear_autotune_cache()
        return got, stats, _tune(mod), mod.autotune_cache_stats()
    port, want = _both(run)
    assert port == want
    assert port[0] == (128, 128)
    assert port[1]["disk_errors"] == 1 and port[1]["tuned"] == 1
    assert port[3] == {"disk_hits": 1}


def test_stale_disk_entry_is_ignored():
    """A disk choice no longer in the candidate list is not served."""
    def run(mod):
        _tune(mod, cands=((64, 64), (32, 32)))
        mod.clear_autotune_cache()
        got = _tune(mod, cands=((128, 128), (256, 256)))
        return got, mod.autotune_cache_stats()
    port, want = _both(run)
    assert port == want
    assert port[0] == (128, 128) and port[1]["tuned"] == 1


def test_cache_dir_override_respected(tmp_path, monkeypatch):
    other = tmp_path / "elsewhere"
    monkeypatch.setenv(dispatch.ENV_CACHE_DIR, str(other))
    dispatch.clear_autotune_cache()
    _tune(dispatch)
    assert dispatch.autotune_cache_dir() == other
    assert (other / dispatch.autotune_cache_path().name).exists()
    # the default is the checkout's build/ (beside the built kernels)
    monkeypatch.delenv(dispatch.ENV_CACHE_DIR)
    from repro_torch.kernels import build
    assert dispatch.autotune_cache_dir() == build.BUILD.parent / "autotune"


def test_persistence_can_be_disabled(tmp_path, monkeypatch):
    monkeypatch.setenv(dispatch.ENV_PERSIST, "0")
    _tune(dispatch)
    assert not any(tmp_path.iterdir())
    assert dispatch.autotune_cache_stats() == {"tuned": 1}


def test_the_cache_file_is_named_for_the_device_kind():
    """One file per device kind, sanitized as the reference's: on a host
    without a card, ``cpu.json``; the card's name as the profile's
    device kind."""
    assert dispatch.autotune_cache_path().name == (
        "cpu.json" if not torch.cuda.is_available() else
        dispatch.sanitize_device_kind(torch.cuda.get_device_name()) + ".json")
    assert (dispatch.sanitize_device_kind("NVIDIA H100 80GB HBM3")
            == "NVIDIA_H100_80GB_HBM3")


def test_tuning_never_times_off_the_card():
    """On CPU tensors the heuristic is cached untimed: the bench never
    runs (as off the TPU in the reference)."""
    calls = []
    t = torch.zeros(4)
    got = dispatch.tuned_blocks("op_x", ("key",), [(128,), (64,)],
                                bench=lambda b: calls.append(b), args=(t,))
    assert got == (128,) and calls == []
    assert dispatch.tuned_blocks("op_x", ("key",), [(64,)],
                                 bench=lambda b: calls.append(b),
                                 args=(t,)) == (128,)  # cached
    assert dispatch.block_candidates(256, (512, 256, 128)) == [256, 128]
    assert dispatch.block_candidates(100, (512, 256, 128)) == [100]


@pytest.mark.parametrize("B,KH,T", [(8, 8, 1024), (1, 2, 40), (64, 16, 4096),
                                    (4, 8, 545)])
def test_decode_tile_candidates(B, KH, T):
    """The dense and paged launchers' tile: tokens per CTA, the
    heuristic (``split_plan``) first, every candidate a whole number of
    the kernel's 32-token tiles, distinct, covering T in its splits."""
    cands = decode_attention.chunk_candidates(B, KH, T)
    assert cands[0] == (decode_attention.split_plan(B, KH, T)[0],)
    assert len(set(cands)) == len(cands) and len(cands) >= 1
    for (c,) in cands:
        assert c % 32 == 0 and c % decode_attention.RANGE == 0
        assert -(-T // c) * c >= T


def test_autotune_cache_at_sets_the_directory_for_the_block(tmp_path):
    """The commands' ``--autotune-cache-dir``: the directory for the run,
    the environment as it was afterwards."""
    before = os.environ.get(dispatch.ENV_CACHE_DIR)
    with dispatch.autotune_cache_at(str(tmp_path / "run")):
        assert dispatch.autotune_cache_dir() == tmp_path / "run"
        _tune(dispatch)
    assert os.environ.get(dispatch.ENV_CACHE_DIR) == before
    assert (tmp_path / "run" / dispatch.autotune_cache_path().name).exists()
    with dispatch.autotune_cache_at(""):
        assert os.environ.get(dispatch.ENV_CACHE_DIR) == before
