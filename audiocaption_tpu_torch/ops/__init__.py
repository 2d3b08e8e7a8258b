"""Frontend and masking primitives (counterpart of ``audiocaption_tpu.ops``)."""
