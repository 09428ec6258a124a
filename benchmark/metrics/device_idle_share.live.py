"""``device_idle_share.live``: see ``readings.idle_share_pct``."""

import readings


def read(ctx):
    return readings.idle_share_pct(ctx)
