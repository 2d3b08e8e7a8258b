"""Host milliseconds per batch inside the entry call, which returns
before the card finishes (the API's and decode selection's own time)."""


def read(info, trace):
    calls = info.get("host_entry_s") or []
    return 1e3 * sum(calls) / len(calls) if calls else None
