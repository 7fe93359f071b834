"""train_mfu: model FLOPs of the window's steps (6 x the active matrix
weights a token, plus causal attention, forward and backward; remat's
recompute not counted) over the window's time and the float32 (TF32
dense) peak."""

from bench import readers, yardstick


def read(run):
    cfg, tr = run.config, run.traffic
    B, S = tr["batch"], tr["seq"]
    attn = sum(yardstick.attention_flops(cfg, p + 1) for p in range(S))
    per_step = B * (S * readers.model_flops_per_token(cfg, True) + 3 * attn)
    steps = run.data["steps"]
    seconds = steps[-1][1] - steps[0][0]
    return readers.share(len(steps) * per_step / seconds,
                         yardstick.PEAK_FLOPS[cfg["dtype"]])
