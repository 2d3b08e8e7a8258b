"""Host utilities of the port (counterpart of ``audiocaption_tpu.utils``)."""
