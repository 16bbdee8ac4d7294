"""GGUF shard sets, the layer database and the stitcher."""
