"""Serving: prefill and batched greedy decode."""
