"""train_tokens_per_s: tokens of every whole step in the window over the
time from the first step's start to the last step's synchronize()."""


def read(run):
    steps = run.data["steps"]
    return len(steps) * run.data["tokens_per_step"] / (steps[-1][1] - steps[0][0])
