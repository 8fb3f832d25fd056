"""setup_s: process start to the first timed unit, in seconds (the
kernel build, the data drawn on the device, the tables, the warm-up)."""


def read(ctx):
    return ctx.setup_s
