"""Continuous-batching serve runtime over paged KV and 2:4-packed
weights (greedy decoding; see ServeConfig for what is not ported)."""
