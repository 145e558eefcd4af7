"""Share of the traced sub-window in which no operation ran on the card.
Moves ``served_rps``."""


def read(ctx):
    tr = ctx["trace"]
    if tr.busy_s <= 0 or tr.window_s <= 0:  # the trace read nothing
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
