"""The device's idle share of the traced window: the time in which no
kernel, copy or fill ran, over the window."""


def read(trace):
    return 1.0 - trace.busy_s / trace.window_s if trace.busy_s > 0 and trace.window_s > 0 else None
