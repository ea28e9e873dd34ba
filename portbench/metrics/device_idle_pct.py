"""The device's idle share of the traced window, in per cent: one less the
union of every device operation's interval over the window."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
