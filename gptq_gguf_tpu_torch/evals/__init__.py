"""Evaluation of the port's models (perplexity, KL against a teacher)."""
