"""``publish_ms.live``: see ``readings.publish_ms``."""

import readings


def read(ctx):
    return readings.publish_ms(ctx)
