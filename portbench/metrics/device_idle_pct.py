"""device_idle_pct (%): share of the traced window in which no kernel,
copy or set ran on the card."""


def read(tr):
    if tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
