"""``dispatch_ms.live``: see ``readings.span_median_ms``."""

import readings


def read(ctx):
    return readings.span_median_ms(ctx, "dispatch")
