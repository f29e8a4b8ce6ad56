"""The window as a whole: every window unit's input read bases over the
traced window's time, in Mbp/s."""


def read(run):
    return run.bases / 1e6 / run.timeline.window_s
