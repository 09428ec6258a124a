"""``step_device_ms.live``: see ``readings.step_device_ms``."""

import readings


def read(ctx):
    return readings.step_device_ms(ctx)
