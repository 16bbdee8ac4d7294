"""GPTQ calibration walk and its per-layer artifacts; the llama-quantize
route (recipes, RTN, importance vectors)."""
