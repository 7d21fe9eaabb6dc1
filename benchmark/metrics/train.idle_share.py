"""Share of the traced window (%) in which no operation ran on the card:
1 - busy / window, busy being the union of the device operations' spans."""


def read(run):
    p = run.profile
    if p.busy_s <= 0 or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
