"""Models of the port (counterpart of ``audiocaption_tpu.models``)."""
