"""Pruning math: the parts the serve slice uses to make 2:4 masks."""
