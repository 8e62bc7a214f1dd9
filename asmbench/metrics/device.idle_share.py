"""The share of the profiled job in which no operation ran on the card:
100 x (1 - the union of the device operations' intervals / the job's
length), from the profiler."""

UNIT = "%"
LAYER = "device"
MOVES = "read_mbp_per_s"


def read(run):
    p = run.profile
    if p is None or not p.window or p.window_s() <= 0:
        return None
    busy = p.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / p.window_s())
