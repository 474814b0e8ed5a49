"""Device ms per training iteration launched inside the FFHQ dual-supervision steps."""

from harness import spans


def read(records):
    return spans.device_ms(records, ("fm3d.train.d_ffhq_step", "fm3d.train.d_ffhq_reg_step",
                                      "fm3d.train.g_ffhq_ds_step"))
