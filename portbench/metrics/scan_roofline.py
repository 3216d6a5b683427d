"""``scan_roofline``: the least time for one batch's work (``work/<kind>.py``,
counted from what the inputs need) over the device-busy time of one batch
in the traced window, in %. Nothing to read without a declared unit of
work or without device time."""

from portbench.harness.roofline import least_seconds


def read(ctx):
    if not ctx["work"] or not ctx["busy_s"] or not ctx["units"]:
        return None
    return 100.0 * least_seconds(ctx["work"]) / (ctx["busy_s"] / ctx["units"])
