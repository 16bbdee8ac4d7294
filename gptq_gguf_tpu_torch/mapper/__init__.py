"""GGUF file-set helpers."""
