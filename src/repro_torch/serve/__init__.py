"""Serving: prefill and greedy decode over the models' caches."""
