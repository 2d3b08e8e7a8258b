"""Caption corpora: tokenizer, datasets and batch collation."""
