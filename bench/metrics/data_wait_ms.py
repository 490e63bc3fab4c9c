"""data_wait_ms: host milliseconds a step waits for its batch, the
benchmark's own span around ``next()`` on the ``Prefetcher``, averaged over
the window's steps. Layer: training loop and data."""


def read(rec):
    waits = rec["data_wait_s"]
    return 1e3 * sum(waits) / len(waits) if waits else None
