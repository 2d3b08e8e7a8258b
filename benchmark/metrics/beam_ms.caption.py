"""Device milliseconds per batch of the work launched inside the
program's ``ac.decode.search`` span: the decode kernel's own time,
without the memory K/V products (``ac.decode.memory_kv``)."""


def read(info, trace):
    calls = trace.span_count("ac.decode.search") if trace is not None else 0
    if not calls:
        return None
    return 1e3 * trace.device_s("ac.decode.search") / calls
