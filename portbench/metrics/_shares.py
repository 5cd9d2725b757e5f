"""What several readers compute alike, from the device trace of the traced window."""

from portbench.flops.peaks import PEAK_FLOPS


def idle_share(run):
    """Percent of the traced window in which no operation ran on the card."""
    t = run.traced
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(run, unit):
    """Useful operations of the traced window's ``unit``s of work (the
    driver's frozen counts) over its seconds, as a percent of the peak of the
    cell's dtype."""
    t, n = run.traced, run.window["counts"].get(unit)
    per = run.driver.flops_per(unit)
    if not t or not n or per is None or t["window_s"] <= 0:
        return None
    return 100.0 * n * per / t["window_s"] / PEAK_FLOPS[run.dtype]
