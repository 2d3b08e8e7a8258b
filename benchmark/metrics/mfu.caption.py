"""Model FLOPs per second of the clips captioned after the traced part
of the window (counted on the reference at each batch's shapes,
``roofline.flops.caption_flops``) over the configuration dtype's peak,
in percent."""


def read(info, trace):
    rate = info.get("model_flops_per_s")
    return None if rate is None else 100.0 * rate / info["peak_flops"]
