"""The decode's least time (the memory K/V products and the beam search's
executed steps, ``roofline.work.decode_work``) over the device time of
the work launched inside the entry span and outside its ``frontend``
and ``encoder`` spans, in percent."""

from roofline.work import bound_s


def read(info, trace):
    work = info.get("decode_work") or []
    if trace is None or not work:
        return None
    device = trace.device_s("entry", outside=("frontend", "encoder"))
    if device <= 0:
        return None
    least = sum(bound_s(f, b, info["dtype"]) for f, b in work)
    return 100.0 * least / device
