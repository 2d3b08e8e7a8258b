"""Device milliseconds per step from the step's start to its
``mark("forward")`` (forward and loss), by CUDA events."""


def read(info, trace):
    return info.get("forward_ms")
