"""Caption scoring: PTB-style normalisation and CIDEr-D."""
