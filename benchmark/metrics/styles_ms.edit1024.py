"""Device ms per edit batch launched inside pSp's lateral fusion and
GradualStyleBlocks (``fm3d.model.psp_styles``)."""

from harness import spans


def read(records):
    return spans.device_ms(records, ("fm3d.model.psp_styles",))
