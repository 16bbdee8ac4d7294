"""GGUF and safetensors containers and GGML block codecs."""
