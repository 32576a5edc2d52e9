"""Device: the share of the traced stretch in which no operation ran on
the card, in %."""


def read(run):
    s = run.stretch
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
