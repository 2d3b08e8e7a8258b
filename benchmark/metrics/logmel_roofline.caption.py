"""The log-mel's least time at the traced calls' shapes
(``roofline.work.logmel_work``) over the device time of the work
launched under the captioner's ``frontend`` span, in percent."""

from roofline.work import bound_s


def read(info, trace):
    work = info.get("frontend_work") or []
    if trace is None or not work:
        return None
    device = trace.device_s("frontend")
    if device <= 0:
        return None
    least = sum(bound_s(f, b, info["dtype"]) for f, b in work)
    return 100.0 * least / device
