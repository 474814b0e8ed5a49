"""Device ms per edit batch launched inside G's two highest synthesis levels
(``fm3d.model.g_level.512`` and ``fm3d.model.g_level.1024``)."""

from harness import spans


def read(records):
    return spans.device_ms(records, ("fm3d.model.g_level.512", "fm3d.model.g_level.1024"))
