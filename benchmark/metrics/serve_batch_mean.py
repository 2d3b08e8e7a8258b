"""Requests served per batch the server dispatched in the window
(``MicroBatchServer.dispatched_batches``)."""


def read(info, trace):
    return info["served"] / info["batches"] if info.get("batches") else None
