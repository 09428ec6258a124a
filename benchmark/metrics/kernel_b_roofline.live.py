"""``kernel_b_roofline.live``: see ``readings.kernel_b_roofline_pct``."""

import readings


def read(ctx):
    return readings.kernel_b_roofline_pct(ctx)
