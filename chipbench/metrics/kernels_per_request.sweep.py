"""Device kernels a sweep request: every kernel the profiler saw in the
traced window over the requests answered in it."""


def read(trace):
    requests = trace.work.get("requests")
    return len(trace.kernels) / requests if requests and trace.kernels else None
