"""Seeded model files the benchmark makes at set-up (never committed)."""
