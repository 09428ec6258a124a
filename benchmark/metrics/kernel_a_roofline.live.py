"""``kernel_a_roofline.live``: see ``readings.kernel_a_roofline_pct``."""

import readings


def read(ctx):
    return readings.kernel_a_roofline_pct(ctx)
