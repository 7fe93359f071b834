"""setup_s: seconds from the process's start to the opening of the window
(loading, weights, warm-up, and the first run's builds)."""


def read(run):
    return run.t_open - run.t_start
