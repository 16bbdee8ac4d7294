"""Export of a quantized model: the GGUF packer and its tokenizer readers."""
