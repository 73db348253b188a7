"""Quantization, the paged KV pool and Flash storage (port of ``repro.core``)."""
