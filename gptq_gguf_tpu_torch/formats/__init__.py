"""GGUF container and GGML block codecs (numpy; no torch needed)."""
