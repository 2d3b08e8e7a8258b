"""Device milliseconds per step from ``mark("forward")`` to
``mark("backward")`` (backward and the gradient clip), by CUDA events."""


def read(info, trace):
    return info.get("backward_ms")
