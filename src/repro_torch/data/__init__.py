"""Data utilities: the byte-level tokenizer the gateway uses for string
prompts."""
