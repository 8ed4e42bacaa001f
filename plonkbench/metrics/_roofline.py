"""The reading shared by the roofline metrics: the least time of a layer's
calls (work.py, from each call's shapes) over the device time of every
activity launched inside them, in percent."""

from plonkbench import work


def share(run, layer):
    tr = run.trace
    if tr is None:
        return None
    calls = [c for c in tr.calls.get(layer, ()) if c.work is not None]
    device_s = sum(c.device_s for c in calls)
    if not calls or device_s <= 0:
        return None
    least = sum(work.least_seconds(*c.work) for c in calls)
    return 100.0 * least / device_s
