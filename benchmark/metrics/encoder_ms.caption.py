"""Device milliseconds per batch of the work launched under the
captioner's ``encoder`` span."""


def read(info, trace):
    if trace is None or not trace.span_count("encoder"):
        return None
    return 1e3 * trace.device_s("encoder") / trace.span_count("encoder")
