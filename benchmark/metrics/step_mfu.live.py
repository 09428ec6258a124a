"""``step_mfu.live``: see ``readings.step_mfu_pct``."""

import readings


def read(ctx):
    return readings.step_mfu_pct(ctx)
