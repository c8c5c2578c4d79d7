"""Device kernels a population epoch: every kernel the profiler saw in the
traced window over the epochs done in it (the population engine's launches,
which do not grow with the population)."""


def read(trace):
    epochs = trace.work.get("epochs")
    return len(trace.kernels) / epochs if epochs and trace.kernels else None
