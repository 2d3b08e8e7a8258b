"""Model FLOPs per second of the steps after the traced part of the
window (the frozen log-mel and Cnn14 forward, three times the BiGRU's and
the teacher-forced decoder's forward; ``roofline.flops.train_flops``)
over the configuration dtype's peak, in percent."""


def read(info, trace):
    rate = info.get("model_flops_per_s")
    return None if rate is None else 100.0 * rate / info["peak_flops"]
