"""Serving: compressed executor, paged KV pool, engine and scheduler."""
