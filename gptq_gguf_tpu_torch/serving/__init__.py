"""KV-cached serving: model step, greedy sampling, continuous batching."""
