"""Model code: the architecture config, the layer library and the LM."""
