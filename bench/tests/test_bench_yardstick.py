"""The frozen yardstick holds the port's work counts at the cells'
shapes, and the configuration files state what the port runs."""

import pytest

from bench import core, yardstick

torch = pytest.importorskip("torch")
from repro_torch.kernels import work  # noqa: E402


@pytest.mark.parametrize("q,kv,causal,el", [
    ((8, 16, 256, 128), (8, 16, 256, 128), True, 4),
    ((1, 16, 256, 128), (1, 16, 256, 128), True, 4),
    ((8, 16, 256, 128), (8, 16, 300, 128), False, 2)])
def test_flash_attention_work_matches_the_port(q, kv, causal, el):
    a, b = yardstick.flash_attention(q, kv, causal, el), \
        work.flash_attention(q, kv, causal, el)
    assert (a.bytes, a.flops) == (b.bytes, b.flops)


def test_peaks_and_least_time():
    assert yardstick.PEAK_FLOPS == {"float32": 495e12, "bfloat16": 989e12}
    assert yardstick.HBM_BYTES_S == 3.35e12
    w = yardstick.Work(bytes=3.35e12, flops=495e12 * 2)
    assert yardstick.least_seconds(w) == 2.0


def test_moe_work_counts_live_assignments_and_experts_hit():
    w = yardstick.moe_ffn(tokens=4, live=6, experts_hit=3, d=8, f=2,
                          n_experts=5, el=4)
    assert w.flops == 2 * 4 * 8 * 5 + 6 * 2 * 3 * 8 * 2
    assert w.bytes == 8 * 5 * 4 + 3 * 3 * 8 * 2 * 4 + 2 * 4 * 8 * 4


@pytest.mark.parametrize("file", sorted(
    p.name for p in (core.BENCH / "configs").glob("*.json")))
def test_configuration_files_state_the_port_arch(file):
    cfg = core.load_json(core.BENCH / "configs" / file)
    arch = core.port_arch(cfg)
    counts = yardstick.lm_param_counts(cfg)
    assert arch.n_layers == cfg["num_hidden_layers"]
    assert arch.hd == cfg["head_dim"]
    per_layer = counts["attn"] + counts["ffn_active"] + counts["router"]
    active = arch.active_param_count() - arch.param_count()["embed"]
    assert yardstick.active_matmul_params(cfg) == (
        cfg["num_hidden_layers"] * per_layer + counts["head"]) == active


def test_a_dense_configuration_counts_its_one_ffn():
    cfg = {"hidden_size": 8, "num_attention_heads": 2,
           "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 16,
           "vocab_size": 10, "num_hidden_layers": 3}
    c = yardstick.lm_param_counts(cfg)
    assert c == {"attn": 8 * 8 + 2 * 8 * 4 + 8 * 8, "ffn_active": 3 * 8 * 16,
                 "router": 0, "head": 80}
    assert yardstick.active_matmul_params(cfg) == 3 * (128 + 64 + 384) + 80
