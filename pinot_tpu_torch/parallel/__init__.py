"""Stacked tables and the macro-batched distributed engine (one device)."""
