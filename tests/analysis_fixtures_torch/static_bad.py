"""Bad: the same Python flags without a static[...] list are device values
(expect RA101 x2, RA202 x1)."""


def launch(lib, q, causal, window):  # repro: device-region
    return lib.launch(q.data_ptr(), int(bool(causal)), int(window))  # RA101 x2


def run(x, lifecycle, now):  # repro: device-region
    if lifecycle:  # RA202
        x = x - now
    return x
