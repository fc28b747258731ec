"""Paged KV cache: page pool, ragged attention, scheduler."""
