"""Text layer: the pure-Python char-level BPE tokenizer."""
