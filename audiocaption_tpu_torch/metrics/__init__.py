"""Caption scoring (counterpart of ``audiocaption_tpu.metrics``): PTB-style
normalisation, BLEU, ROUGE-L, CIDEr-D, ``meteor_py``, ``spice_py``, the
``evaluate_captions`` aggregator, diversity, specificity and the seed
report tools."""
