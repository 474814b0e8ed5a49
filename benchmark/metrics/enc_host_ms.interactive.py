"""Host ms per interactive edit request inside the three encoders' spans."""

from harness import spans


def read(records):
    return spans.host_ms(records, ("fm3d.model.e_tsr", "fm3d.model.e_w", "fm3d.model.e_w_plus"))
