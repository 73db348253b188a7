"""Data utilities: the byte-level tokenizer (the gateway's string prompts)
and the synthetic training pipeline."""
