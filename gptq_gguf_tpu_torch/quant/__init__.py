"""GPTQ calibration walk and its per-layer artifacts."""
