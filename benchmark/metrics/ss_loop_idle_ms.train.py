"""Device-idle milliseconds per step in the gaps that a launch made
inside the scheduled-sampling loop (``ac.ss_loop``) ended, over the
steps (``ac.train.forward`` spans).  A gap is the launch's by the host
time of the launch that ends it, as ``Trace.idle_gaps`` finds that
launch, whatever thread made it (``harness/program_spans.py``); the loop
runs in the forward on the main thread."""

from harness import program_spans


def read(info, trace):
    steps = trace.span_count("ac.train.forward") if trace is not None else 0
    if not steps:
        return None
    return 1e3 * program_spans.idle_s_ended_in(trace, "ac.ss_loop") / steps
