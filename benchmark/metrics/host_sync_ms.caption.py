"""Host milliseconds per batch that the program waited for the card at
its deliberate device-to-host reads (its ``ac.sync.*`` spans) inside the
entry call, over the entry calls.  0 where the entry reads nothing
back; nothing where the program records no span of its own."""

from harness import program_spans


def read(info, trace):
    calls = trace.span_count("entry") if trace is not None else 0
    if not calls or not program_spans.instrumented(trace):
        return None
    return 1e3 * program_spans.host_s(trace, program_spans.SYNC,
                                      within="entry") / calls
