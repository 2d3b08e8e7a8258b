"""Host milliseconds per step that the program waited for the card at
its deliberate device-to-host reads (its ``ac.sync.*`` spans) in the
traced window, over the steps (``ac.train.forward`` spans)."""

from harness import program_spans


def read(info, trace):
    steps = trace.span_count("ac.train.forward") if trace is not None else 0
    if not steps:
        return None
    return 1e3 * program_spans.host_s(trace, program_spans.SYNC) / steps
