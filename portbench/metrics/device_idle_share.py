"""The card as a whole: the share of the traced window in which no kernel,
copy or fill ran on it, in %."""


def read(run):
    t = run.timeline
    return 100.0 * (1.0 - t.busy_s / t.window_s)
