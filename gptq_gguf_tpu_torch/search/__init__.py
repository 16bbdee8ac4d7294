"""EvoPress bit-width search over the layer database."""
