"""Host ms per interactive edit request inside the generator's span."""

from harness import spans


def read(records):
    return spans.host_ms(records, ("fm3d.model.generator",))
