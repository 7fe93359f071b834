"""The window arithmetic of the training metrics: a stall placed inside
the window lowers train_tokens_per_s and train_mfu, which are taken over
every whole step and all the time from the first step's start to the
last step's end."""

from bench import core


class _Cell:
    spec = {"end_to_end": [{"name": "train_tokens_per_s", "unit": "u"}],
            "per_layer": [{"name": "train_mfu", "unit": "u"}]}
    name = "c"
    config = {"hidden_size": 64, "num_attention_heads": 4,
              "num_key_value_heads": 4, "head_dim": 16,
              "intermediate_size": 32, "num_experts": 8,
              "num_experts_per_tok": 2, "vocab_size": 128,
              "num_hidden_layers": 2, "dtype": "float32"}
    traffic = {"batch": 4, "seq": 32}
    limits = {}

    metrics = core.Cell.metrics


def _metrics(stall_at=None, stall=0.0, traced=False):
    """Twenty steps of 0.5 s back to back; the step ``stall_at`` takes
    ``stall`` seconds more, and every later one starts that much later."""
    run = core.Run(_Cell(), 0, 10.0, traced, 0.0)
    steps, t = [], 0.0
    for i in range(20):
        dt = 0.5 + (stall if i == stall_at else 0.0)
        steps.append((t, t + dt))
        t += dt
    run.data.update(steps=steps, tokens_per_step=128)
    run.t_open, run.t_close = 0.0, steps[-1][1]
    return {k: v["value"] for k, v in core.compute_metrics(run, traced).items()}


def test_a_stall_inside_the_window_lowers_the_rate_and_the_mfu():
    base, stalled = _metrics(), _metrics(stall_at=7, stall=2.0)
    assert base["train_tokens_per_s"] == 20 * 128 / 10.0
    assert stalled["train_tokens_per_s"] == 20 * 128 / 12.0
    mfu = _metrics(traced=True)["train_mfu"]
    assert _metrics(stall_at=7, stall=2.0, traced=True)["train_mfu"] < mfu


def test_the_rate_counts_every_step_and_not_a_median():
    # one slow step in twenty moves the rate by its whole share of the time
    a = _metrics(stall_at=0, stall=5.0)["train_tokens_per_s"]
    b = _metrics(stall_at=19, stall=5.0)["train_tokens_per_s"]
    assert a == b == 20 * 128 / 15.0
