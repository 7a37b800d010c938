"""device_idle_share.backlog: 1 - the union of the device's records over
the traced slice's wall time (the backlog cells; in an open loop it would
mostly measure the gaps between arrivals)."""


def read(run):
    if run.slice is None or run.slice.wall_s <= 0:
        return None
    return 1.0 - run.slice.busy_s() / run.slice.wall_s
